// framecodec: host-side pixel-format conversion kernels.
//
// The TPU-native pipeline keeps FFmpeg/container I/O on the host
// (SURVEY.md §2.3: NVDEC has no TPU equivalent); what remains hot on the
// host is per-frame colorspace/packing conversion — ~25 Mpixels/frame at
// 4K, done in numpy float in the fallback path. These kernels do it in
// fixed-point integer arithmetic with OpenMP across rows.
//
// Conventions: RGB is interleaved uint8 (H, W, 3); YUV is planar uint8
// studio-range BT.601 (Y: HxW, U/V: H/2 x W/2 for 4:2:0, HxW for 4:4:4).
//
// Built lazily by video_restore_tpu/utils/native.py:
//   g++ -O3 -shared -fPIC -fopenmp framecodec.cpp -o libframecodec.so

#include <cstdint>
#include <cstring>
#include <algorithm>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

static inline uint8_t clamp_u8(int v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// BT.601 studio-range, 8-bit fixed point (ITU integer approximation).
//   Y =  16 + ( 66R + 129G +  25B + 128) >> 8
//   U = 128 + (-38R -  74G + 112B + 128) >> 8
//   V = 128 + (112R -  94G -  18B + 128) >> 8
void rgb_to_yuv420(const uint8_t* rgb, int h, int w,
                   uint8_t* y, uint8_t* u, uint8_t* v) {
    const int cw = w / 2;
#pragma omp parallel for schedule(static)
    for (int r2 = 0; r2 < h / 2; ++r2) {
        for (int c2 = 0; c2 < cw; ++c2) {
            int usum = 0, vsum = 0;
            for (int dy = 0; dy < 2; ++dy) {
                const int row = r2 * 2 + dy;
                const uint8_t* p = rgb + ((size_t)row * w + c2 * 2) * 3;
                uint8_t* yrow = y + (size_t)row * w + c2 * 2;
                for (int dx = 0; dx < 2; ++dx) {
                    const int R = p[0], G = p[1], B = p[2];
                    yrow[dx] = clamp_u8(16 + ((66 * R + 129 * G + 25 * B + 128) >> 8));
                    usum += 128 + ((-38 * R - 74 * G + 112 * B + 128) >> 8);
                    vsum += 128 + ((112 * R - 94 * G - 18 * B + 128) >> 8);
                    p += 3;
                }
            }
            u[(size_t)r2 * cw + c2] = clamp_u8((usum + 2) >> 2);
            v[(size_t)r2 * cw + c2] = clamp_u8((vsum + 2) >> 2);
        }
    }
}

void rgb_to_yuv444(const uint8_t* rgb, int h, int w,
                   uint8_t* y, uint8_t* u, uint8_t* v) {
#pragma omp parallel for schedule(static)
    for (int row = 0; row < h; ++row) {
        const uint8_t* p = rgb + (size_t)row * w * 3;
        uint8_t* yr = y + (size_t)row * w;
        uint8_t* ur = u + (size_t)row * w;
        uint8_t* vr = v + (size_t)row * w;
        for (int c = 0; c < w; ++c) {
            const int R = p[0], G = p[1], B = p[2];
            yr[c] = clamp_u8(16 + ((66 * R + 129 * G + 25 * B + 128) >> 8));
            ur[c] = clamp_u8(128 + ((-38 * R - 74 * G + 112 * B + 128) >> 8));
            vr[c] = clamp_u8(128 + ((112 * R - 94 * G - 18 * B + 128) >> 8));
            p += 3;
        }
    }
}

//   R = (298(Y-16)            + 409(V-128) + 128) >> 8
//   G = (298(Y-16) - 100(U-128) - 208(V-128) + 128) >> 8
//   B = (298(Y-16) + 516(U-128)             + 128) >> 8
void yuv420_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                   int h, int w, uint8_t* rgb) {
    const int cw = w / 2;
#pragma omp parallel for schedule(static)
    for (int row = 0; row < h; ++row) {
        const uint8_t* yr = y + (size_t)row * w;
        const uint8_t* ur = u + (size_t)(row / 2) * cw;
        const uint8_t* vr = v + (size_t)(row / 2) * cw;
        uint8_t* p = rgb + (size_t)row * w * 3;
        for (int c = 0; c < w; ++c) {
            const int Y = 298 * ((int)yr[c] - 16);
            const int U = (int)ur[c / 2] - 128;
            const int V = (int)vr[c / 2] - 128;
            p[0] = clamp_u8((Y + 409 * V + 128) >> 8);
            p[1] = clamp_u8((Y - 100 * U - 208 * V + 128) >> 8);
            p[2] = clamp_u8((Y + 516 * U + 128) >> 8);
            p += 3;
        }
    }
}

void yuv444_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                   int h, int w, uint8_t* rgb) {
#pragma omp parallel for schedule(static)
    for (int row = 0; row < h; ++row) {
        const uint8_t* yr = y + (size_t)row * w;
        const uint8_t* ur = u + (size_t)row * w;
        const uint8_t* vr = v + (size_t)row * w;
        uint8_t* p = rgb + (size_t)row * w * 3;
        for (int c = 0; c < w; ++c) {
            const int Y = 298 * ((int)yr[c] - 16);
            const int U = (int)ur[c] - 128;
            const int V = (int)vr[c] - 128;
            p[0] = clamp_u8((Y + 409 * V + 128) >> 8);
            p[1] = clamp_u8((Y - 100 * U - 208 * V + 128) >> 8);
            p[2] = clamp_u8((Y + 516 * U + 128) >> 8);
            p += 3;
        }
    }
}

// BGR<->RGB swap (OpenCV boundary) without an intermediate copy in Python.
void swap_rb(const uint8_t* src, int h, int w, uint8_t* dst) {
    const size_t n = (size_t)h * w;
#pragma omp parallel for schedule(static)
    for (long long i = 0; i < (long long)n; ++i) {
        const uint8_t* s = src + i * 3;
        uint8_t* d = dst + i * 3;
        d[0] = s[2];
        d[1] = s[1];
        d[2] = s[0];
    }
}

int framecodec_abi_version() { return 1; }

}  // extern "C"
