// Fused host-side image pipeline: JPEG decode -> resize -> BGR mean-subtract
// -> fixed canvas, in one pass (dtt_torch's copy of dtt's pixelops.cpp; the
// arithmetic is the same line for line, so both give the same bits).
//
// The reference's blob path (lib/roi_data_layer/minibatch.py
// _get_image_blob) reads, resizes, subtracts the mean and copies into the
// canvas in four full-image passes. Here libjpeg decodes straight at a DCT
// scale k/8 just above the target scale, and one pass resizes (bilinear,
// half-pixel centres, clamped at the edges), mirrors, converts RGB to BGR and
// subtracts the mean into a caller-zeroed canvas.
//
// Built by dtt_torch/data/native.py at first use:
//   g++ -O3 -march=native -shared -fPIC pixelops.cpp -ljpeg -o <lib>

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

}  // namespace

extern "C" {

// Decode `jpeg_bytes` and write a float32 HWC BGR canvas:
//   scale = min(target_short / min(h, w), canvas_h / h, canvas_w / w)
//   resized (bilinear) image placed at the canvas origin, mean-subtracted;
//   the rest of the canvas is left as the caller zeroed it.
// Returns 0 on success; *out_scale receives the applied scale.
// flip != 0 mirrors horizontally (done during the fused pass).
int decode_resize_normalize(const uint8_t* jpeg_bytes, long len,
                            float* canvas, int canvas_h, int canvas_w,
                            float target_short, const float* mean_bgr,
                            int flip, float* out_scale) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, jpeg_bytes, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }

  const int full_h = static_cast<int>(cinfo.image_height);
  const int full_w = static_cast<int>(cinfo.image_width);
  float scale = target_short / static_cast<float>(full_h < full_w ? full_h : full_w);
  float cap_h = static_cast<float>(canvas_h) / full_h;
  float cap_w = static_cast<float>(canvas_w) / full_w;
  if (scale > cap_h) scale = cap_h;
  if (scale > cap_w) scale = cap_w;
  const int nh = static_cast<int>(scale * full_h + 0.5f);
  const int nw = static_cast<int>(scale * full_w + 0.5f);
  *out_scale = scale;

  // DCT-domain pre-scale: smallest k/8 >= needed scale (k in 1..8).
  int k = static_cast<int>(scale * 8.0f) + 1;
  if (k > 8) k = 8;
  if (k < 1) k = 1;
  cinfo.scale_num = k;
  cinfo.scale_denom = 8;
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int dh = static_cast<int>(cinfo.output_height);
  const int dw = static_cast<int>(cinfo.output_width);
  const int dc = cinfo.output_components;  // 3

  std::vector<uint8_t> decoded(static_cast<size_t>(dh) * dw * dc);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = decoded.data() + static_cast<size_t>(cinfo.output_scanline) * dw * dc;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // Fused bilinear resize (dh,dw) -> (nh,nw) + RGB->BGR + mean-subtract +
  // optional flip, written straight into the canvas.
  const float ry = nh > 1 ? static_cast<float>(dh) / nh : 0.f;
  const float rx = nw > 1 ? static_cast<float>(dw) / nw : 0.f;
  const float m0 = mean_bgr[0], m1 = mean_bgr[1], m2 = mean_bgr[2];

  std::vector<int> x0s(nw), x1s(nw);
  std::vector<float> lxs(nw);
  for (int x = 0; x < nw; ++x) {
    float sx = (x + 0.5f) * rx - 0.5f;
    if (sx < 0) sx = 0;
    int x0 = static_cast<int>(sx);
    int x1 = x0 + 1 < dw ? x0 + 1 : dw - 1;
    x0s[x] = x0; x1s[x] = x1; lxs[x] = sx - x0;
  }

  for (int y = 0; y < nh; ++y) {
    float sy = (y + 0.5f) * ry - 0.5f;
    if (sy < 0) sy = 0;
    int y0 = static_cast<int>(sy);
    int y1 = y0 + 1 < dh ? y0 + 1 : dh - 1;
    const float ly = sy - y0;
    const uint8_t* r0 = decoded.data() + static_cast<size_t>(y0) * dw * dc;
    const uint8_t* r1 = decoded.data() + static_cast<size_t>(y1) * dw * dc;
    float* out_row = canvas + static_cast<size_t>(y) * canvas_w * 3;
    for (int x = 0; x < nw; ++x) {
      const int ox = flip ? (nw - 1 - x) : x;
      const int x0 = x0s[x] * dc, x1 = x1s[x] * dc;
      const float lx = lxs[x];
      const float w00 = (1 - ly) * (1 - lx), w01 = (1 - ly) * lx;
      const float w10 = ly * (1 - lx), w11 = ly * lx;
      // source is RGB; canvas is BGR
      const float r = w00 * r0[x0] + w01 * r0[x1] + w10 * r1[x0] + w11 * r1[x1];
      const float g = w00 * r0[x0 + 1] + w01 * r0[x1 + 1] + w10 * r1[x0 + 1] + w11 * r1[x1 + 1];
      const float b = w00 * r0[x0 + 2] + w01 * r0[x1 + 2] + w10 * r1[x0 + 2] + w11 * r1[x1 + 2];
      float* px = out_row + static_cast<size_t>(ox) * 3;
      px[0] = b - m0;
      px[1] = g - m1;
      px[2] = r - m2;
    }
  }
  return 0;
}

}  // extern "C"
