/* The CIFAR training augmentation as one host pass, OpenMP over images:
 * crop at (ys[i], xs[i]) of the image zero-padded by `pad`, mirror it
 * horizontally where flips[i], and normalise u8 -> f32 as
 * u8 * scale[c] + bias[c] (scale = 1 / (255 std), bias = -mean / std).
 * Reads the source image directly (the padding is implicit, the flip is
 * folded into the column index), writes NHWC f32. The host compiler
 * builds it with -ffp-contract=off: a multiply and an add, each rounded,
 * as numpy computes them (dgc_tpu_torch/data/native.py has that plain
 * version). */
#include <stdint.h>

void crop_flip_normalize(
    const uint8_t* in, float* out,
    const int32_t* ys, const int32_t* xs, const uint8_t* flips,
    int64_t n, int64_t h, int64_t w, int64_t pad,
    const float* scale, const float* bias)
{
    #pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* src = in + i * h * w * 3;
        float* dst = out + i * h * w * 3;
        const int64_t oy = (int64_t)ys[i] - pad;
        const int64_t ox = (int64_t)xs[i] - pad;
        const int flip = flips[i];
        for (int64_t y = 0; y < h; ++y) {
            const int64_t sy = y + oy;
            const int in_y = (sy >= 0 && sy < h);
            for (int64_t x = 0; x < w; ++x) {
                const int64_t xcol = flip ? (w - 1 - x) : x;
                const int64_t sx = xcol + ox;
                float* o = dst + (y * w + x) * 3;
                if (in_y && sx >= 0 && sx < w) {
                    const uint8_t* s = src + (sy * w + sx) * 3;
                    o[0] = s[0] * scale[0] + bias[0];
                    o[1] = s[1] * scale[1] + bias[1];
                    o[2] = s[2] * scale[2] + bias[2];
                } else {
                    o[0] = bias[0];
                    o[1] = bias[1];
                    o[2] = bias[2];
                }
            }
        }
    }
}
