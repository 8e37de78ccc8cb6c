"""Dataset registry (counterpart of ``dtt.data.imdb``).

The reference's imdb factory (lib/datasets/factory.py): names map to
dataset builders, and ``combined_roidb`` concatenates the roidbs of
'+'-joined names.
"""

from __future__ import annotations

from typing import Callable, Dict, List

_REGISTRY: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(fn):
        if name in _REGISTRY:
            raise KeyError(f"dataset {name!r} already registered")
        _REGISTRY[name] = fn
        return fn
    return deco


def get_dataset(name: str, **kwargs):
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_datasets() -> List[str]:
    return sorted(_REGISTRY)


def combined_roidb(names: str, **kwargs) -> list:
    """The roidbs of '+'-joined dataset names, concatenated
    ('imagenet_vid_train+imagenet_det_train').

    Each entry is tagged with its dataset's name under "source", so the
    loader can set the DET:VID mixture (``input.det_fraction``): DET's
    roidb is ~10x VID's pair set, and a plain concatenation would train
    mostly on identity pairs (D&T paper §3.4)."""
    roidb = []
    for name in names.split("+"):
        name = name.strip()
        entries = get_dataset(name, **kwargs).roidb()
        for e in entries:
            e["source"] = name
        roidb.extend(entries)
    return roidb
