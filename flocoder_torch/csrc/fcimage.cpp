// fcimage — native image decode + resize of flocoder_torch's host pipeline,
// the port's own copy of the C++ decoder beside the JAX package.
//
// JPEG via libjpeg, PNG via libpng, followed by a PIL-compatible separable
// triangle (BILINEAR) resample, so the Python side receives a ready
// (S, S, 3) uint8 buffer per image and the per-image PIL decode leaves the
// hot path. The batched entry point fans files out over threads writing
// disjoint output slices (no locks).
//
// Decode semantics match PIL's convert("RGB"): grayscale expands to RGB,
// 16-bit PNG strips to 8, alpha is dropped (not composited). The resampler
// follows PIL Resample.c's algorithm (center = (i+.5)*scale, support
// scaled by max(scale, 1) for downscale anti-aliasing, weights normalized)
// in float32 — PIL quantizes coefficients to 8-bit fixed point, so parity
// with PIL is within ±2/255 (tests/test_torch_native_image.py).
//
// Built at first use by flocoder_torch/ops/kernels/build.py
// (build_host_library): g++ -O3 -shared -fPIC -pthread -std=c++17 ... -ljpeg -lpng

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------- JPEG ----

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(e->jb, 1);
}

// Decode a JPEG file to RGB8. Returns true on success; *out is resized to
// (*h) * (*w) * 3.
bool decode_jpeg(FILE* f, std::vector<uint8_t>* out, int* w, int* h) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    *w = cinfo.output_width;
    *h = cinfo.output_height;
    out->resize(size_t(*w) * (*h) * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out->data() + size_t(cinfo.output_scanline) * (*w) * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
}

// ----------------------------------------------------------------- PNG ----

bool decode_png(FILE* f, std::vector<uint8_t>* out, int* w, int* h) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    if (!png) return false;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return false;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return false;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    // normalize every variant to 8-bit RGB (PIL convert("RGB") semantics)
    png_byte color = png_get_color_type(png, info);
    png_byte depth = png_get_bit_depth(png, info);
    if (depth == 16) png_set_strip_16(png);
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
        png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
        png_set_gray_to_rgb(png);
    png_set_strip_alpha(png);  // PIL convert("RGB") drops alpha
    png_read_update_info(png, info);
    *w = png_get_image_width(png, info);
    *h = png_get_image_height(png, info);
    out->resize(size_t(*w) * (*h) * 3);
    std::vector<png_bytep> rows(*h);
    for (int y = 0; y < *h; ++y)
        rows[y] = out->data() + size_t(y) * (*w) * 3;
    png_read_image(png, rows.data());
    png_read_end(png, nullptr);
    png_destroy_read_struct(&png, &info, nullptr);
    return true;
}

bool decode_file(const char* path, std::vector<uint8_t>* out, int* w, int* h) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    uint8_t magic[4] = {0};
    size_t got = fread(magic, 1, 4, f);
    rewind(f);
    bool ok = false;
    if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8)
        ok = decode_jpeg(f, out, w, h);
    else if (got >= 4 && magic[0] == 0x89 && magic[1] == 'P' &&
             magic[2] == 'N' && magic[3] == 'G')
        ok = decode_png(f, out, w, h);
    fclose(f);
    return ok;
}

// ------------------------------------------------------------- resample ----

// One axis of PIL's triangle-filter resample (Resample.c): per output index,
// the contributing input range and normalized weights.
struct AxisCoeffs {
    std::vector<int> xmin, xlen;
    std::vector<float> weights;  // packed, ksize per output index
    int ksize;
};

AxisCoeffs triangle_coeffs(int in_size, int out_size) {
    AxisCoeffs c;
    double scale = double(in_size) / out_size;
    double filterscale = std::max(scale, 1.0);
    double support = 1.0 * filterscale;  // bilinear filter support = 1.0
    c.ksize = int(std::ceil(support)) * 2 + 1;
    c.xmin.resize(out_size);
    c.xlen.resize(out_size);
    c.weights.assign(size_t(out_size) * c.ksize, 0.f);
    for (int i = 0; i < out_size; ++i) {
        double center = (i + 0.5) * scale;
        int xmin = std::max(0, int(center - support + 0.5));
        int xmax = std::min(in_size, int(center + support + 0.5));
        double sum = 0.0;
        std::vector<double> wk(xmax - xmin);
        for (int x = xmin; x < xmax; ++x) {
            double t = std::abs((x - center + 0.5) / filterscale);
            double wv = t < 1.0 ? 1.0 - t : 0.0;
            wk[x - xmin] = wv;
            sum += wv;
        }
        c.xmin[i] = xmin;
        c.xlen[i] = xmax - xmin;
        for (int k = 0; k < xmax - xmin; ++k)
            c.weights[size_t(i) * c.ksize + k] =
                float(sum > 0 ? wk[k] / sum : 0.0);
    }
    return c;
}

// Separable resize RGB8 (h, w) → RGB8 (th, tw), float accumulation.
void resize_rgb(const uint8_t* src, int w, int h, uint8_t* dst, int tw,
                int th) {
    if (w == tw && h == th) {
        std::memcpy(dst, src, size_t(w) * h * 3);
        return;
    }
    AxisCoeffs cx = triangle_coeffs(w, tw);
    AxisCoeffs cy = triangle_coeffs(h, th);
    // horizontal pass → float (h, tw, 3)
    std::vector<float> tmp(size_t(h) * tw * 3);
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = src + size_t(y) * w * 3;
        float* orow = tmp.data() + size_t(y) * tw * 3;
        for (int i = 0; i < tw; ++i) {
            const float* wts = &cx.weights[size_t(i) * cx.ksize];
            float r = 0, g = 0, b = 0;
            int x0 = cx.xmin[i];
            for (int k = 0; k < cx.xlen[i]; ++k) {
                const uint8_t* p = row + size_t(x0 + k) * 3;
                r += wts[k] * p[0];
                g += wts[k] * p[1];
                b += wts[k] * p[2];
            }
            orow[i * 3 + 0] = r;
            orow[i * 3 + 1] = g;
            orow[i * 3 + 2] = b;
        }
    }
    // vertical pass → uint8 (th, tw, 3)
    for (int j = 0; j < th; ++j) {
        const float* wts = &cy.weights[size_t(j) * cy.ksize];
        int y0 = cy.xmin[j];
        uint8_t* orow = dst + size_t(j) * tw * 3;
        for (int i = 0; i < tw * 3; ++i) {
            float acc = 0;
            for (int k = 0; k < cy.xlen[j]; ++k)
                acc += wts[k] * tmp[size_t(y0 + k) * tw * 3 + i];
            orow[i] = uint8_t(std::clamp(int(std::lround(acc)), 0, 255));
        }
    }
}

}  // namespace

extern "C" {

// Probe image dimensions without full decode (full decode for simplicity —
// probe is only used by tests). Returns 0 on success.
int fci_probe(const char* path, int* w, int* h) {
    std::vector<uint8_t> buf;
    return decode_file(path, &buf, w, h) ? 0 : -1;
}

// Decode + resize one image into out (tw*th*3 uint8, caller-allocated).
// Returns 0 on success, -1 on decode failure.
int fci_decode_resize(const char* path, uint8_t* out, int tw, int th) {
    std::vector<uint8_t> buf;
    int w = 0, h = 0;
    if (!decode_file(path, &buf, &w, &h)) return -1;
    resize_rgb(buf.data(), w, h, out, tw, th);
    return 0;
}

// Batched threaded decode+resize: n images into out (n, th, tw, 3).
// status[i] = 0 on success, -1 on failure (caller redraws). paths is a
// packed array of NUL-terminated strings, offsets[i] indexing into it.
void fci_decode_resize_batch(const char* paths, const int64_t* offsets,
                             int64_t n, uint8_t* out, int tw, int th,
                             int n_threads, int* status) {
    size_t stride = size_t(tw) * th * 3;
    n_threads = std::max(1, std::min<int>(n_threads, n));
    std::vector<std::thread> threads;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) return;
            status[i] = fci_decode_resize(paths + offsets[i],
                                          out + size_t(i) * stride, tw, th);
        }
    };
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
}

}  // extern "C"
