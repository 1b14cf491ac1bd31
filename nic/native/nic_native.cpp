// Native runtime helpers for the nic framework (host-side, off the device
// compute path): sub-byte bit-packing for compressed artifacts and a fast
// LUT→CSV exporter.
//
// The reference (21K1113/Neural_Image_Compression_V2) stores every b-bit
// grid code as a whole uint8 (fp_def.py:250-255) and exports LUT CSVs with
// a Python triple loop building one giant string (utils.py:97-113) — both
// are host-runtime jobs that belong in native code. Built as a plain
// shared library, bound via ctypes (no pybind11 in this image); nic falls
// back to numpy implementations when the .so is absent.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Pack `count` codes (one per byte, values < 2^bits) into a TRUE bit
// stream: code i at absolute bits [i*b, (i+1)*b), LSB-first, straddling
// byte boundaries when b does not divide 8 — exactly ceil(count*b/8)
// bytes for every b in [1, 8]. For b | 8 this coincides with the
// historical codes-per-byte layout (old artifacts stay readable).
// Returns number of bytes written.
int64_t nic_pack_bits(const uint8_t* codes, int64_t count, int bits,
                      uint8_t* out) {
    if (bits == 8) {
        memcpy(out, codes, static_cast<size_t>(count));
        return count;
    }
    const uint32_t mask = (1u << bits) - 1u;
    uint32_t acc = 0;
    int nbits = 0;
    int64_t o = 0;
    for (int64_t i = 0; i < count; ++i) {
        acc |= (static_cast<uint32_t>(codes[i]) & mask) << nbits;
        nbits += bits;
        while (nbits >= 8) {
            out[o++] = static_cast<uint8_t>(acc & 0xffu);
            acc >>= 8;
            nbits -= 8;
        }
    }
    if (nbits > 0) out[o++] = static_cast<uint8_t>(acc & 0xffu);
    return o;
}

// Inverse of nic_pack_bits: expand the byte stream back to `count` codes.
void nic_unpack_bits(const uint8_t* packed, int64_t count, int bits,
                     uint8_t* out) {
    if (bits == 8) {
        memcpy(out, packed, static_cast<size_t>(count));
        return;
    }
    const uint32_t mask = (1u << bits) - 1u;
    uint32_t acc = 0;
    int nbits = 0;
    int64_t o = 0;
    for (int64_t i = 0; i < count; ++i) {
        while (nbits < bits) {
            acc |= static_cast<uint32_t>(packed[o++]) << nbits;
            nbits += 8;
        }
        out[i] = static_cast<uint8_t>(acc & mask);
        acc >>= bits;
        nbits -= bits;
    }
}

// Write an [S,S,S,3] float32 LUT as CSV in the reference's layout
// (utils.py:97-113): S*S lines, each S*3 comma-terminated values.
// Returns 0 on success, -1 on I/O error.
int nic_write_lut_csv(const float* lut, int64_t size, const char* path) {
    FILE* f = fopen(path, "w");
    if (!f) return -1;
    const int64_t s = size;
    for (int64_t a = 0; a < s; ++a) {
        for (int64_t b = 0; b < s; ++b) {
            for (int64_t r = 0; r < s; ++r) {
                const float* px = lut + ((a * s + b) * s + r) * 3;
                // %.9g reproduces float32 values exactly in decimal
                fprintf(f, "%.9g,%.9g,%.9g,", px[0], px[1], px[2]);
            }
            fputc('\n', f);
        }
    }
    if (fclose(f) != 0) return -1;
    return 0;
}

}  // extern "C"
