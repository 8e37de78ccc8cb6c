"""Where the NMS kernel keeps a problem (`nms_layout`), on the CPU: the
body and bytes it picks at the port's sizes (K = 300 and 330 for the
per-class NMS and OHEM, 6,000 for the proposals, 12,000 for the train
budget, 49,152 the most the kernel takes), the shared memory it asks for
under a block's 227 KB at every K, and the constants it shares with
``csrc/nms.cu``. No JAX and no card.
"""

import re
from pathlib import Path

import pytest

from dtt_torch.ops import nms as tnms

SOURCE = Path(tnms.__file__).parent / "csrc" / "nms.cu"
MAX_K = 49152


def _constant(name):
    return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                         SOURCE.read_text()).group(1))


@pytest.mark.parametrize("k, body, smem, scratch", [
    (300, "shared", 24 * 320 + 12 * 10, 0),
    (330, "shared", 24 * 352 + 12 * 11, 0),
    (6000, "shared", 24 * 6016 + 12 * 188, 0),
    (12000, "scratch", 12 * 375, 24 * 12000),
    (MAX_K, "scratch", 12 * 1536, 24 * MAX_K)])
def test_nms_layout_at_the_port_sizes(k, body, smem, scratch):
    """24 bytes a box (rounded up to 32 boxes) staged in shared memory or
    in scratch, 12 bytes a 32 boxes of bit words in shared memory."""
    assert tnms.nms_layout(k) == (body, smem, scratch)


def test_nms_layout_fits_a_block_at_every_k():
    """Every K from 1 to the kernel's most asks for at most 227 KB with the
    kernel's static part, and the staged boxes leave shared memory once,
    past 9,472 boxes."""
    bodies = []
    for k in range(1, MAX_K + 1):
        lay = tnms.nms_layout(k)
        assert lay.smem + tnms._STATIC_SMEM <= tnms.SMEM_LIMIT == 232_448, k
        assert (lay.scratch == 0) == (lay.body == "shared"), k
        bodies.append(lay.body)
    assert bodies.index("scratch") == 9472
    assert set(bodies[9472:]) == {"scratch"}


def test_nms_layout_agrees_with_the_kernel_source():
    """The static bytes it leaves and the largest K are the kernel's."""
    assert _constant("kStaticSmem") == tnms._STATIC_SMEM
    assert _constant("kMaxK") == MAX_K
    assert _constant("kWidth") == tnms.KERNEL_BLOCK
