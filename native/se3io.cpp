// Native host-runtime accelerator for se3-icp.
//
// The reference's runtime layer is C++ (Open3D IO, FLANN, OpenMP); the
// device compute path here is XLA/Pallas, and this library provides the
// native counterpart for the host side: bulk binary block reads for the
// PLY loader (se3_icp/utils/ply.py) and OpenMP-parallel staging of
// whole benchmark sequences (551 KITTI clouds, 80 lounge frames) into a
// caller-provided arena ahead of device upload.
//
// Build: `make -C native` -> libse3io.so, loaded via ctypes
// (se3_icp/utils/native.py). Everything degrades to numpy when the
// library is absent.

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Read `nbytes` from `path` starting at byte `offset` into `out`.
// Returns bytes read, or -1 on open failure.
long long se3io_read_block(const char* path, long long offset,
                           long long nbytes, void* out) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  long long total = 0;
  char* dst = static_cast<char*>(out);
  while (total < nbytes) {
    ssize_t got = ::pread(fd, dst + total, nbytes - total, offset + total);
    if (got <= 0) break;
    total += got;
  }
  ::close(fd);
  return total;
}

// Parallel multi-file block read: for each i, read nbytes[i] bytes from
// paths[i] (a packed, NUL-separated string buffer indexed by path_offsets)
// at offsets[i] into out + out_offsets[i]. Returns number of failures.
long long se3io_read_blocks(const char* paths_buf,
                            const long long* path_offsets,
                            const long long* offsets,
                            const long long* nbytes,
                            const long long* out_offsets, long long count,
                            void* out) {
  long long failures = 0;
#ifdef _OPENMP
#pragma omp parallel for reduction(+ : failures) schedule(dynamic)
#endif
  for (long long i = 0; i < count; ++i) {
    const char* path = paths_buf + path_offsets[i];
    char* dst = static_cast<char*>(out) + out_offsets[i];
    long long got = se3io_read_block(path, offsets[i], nbytes[i], dst);
    if (got != nbytes[i]) failures += 1;
  }
  return failures;
}

// Convert interleaved float64 xyz records with arbitrary stride into a
// packed float32 [n,3] buffer (PLY payloads with extra properties).
void se3io_strided_f64_to_f32_xyz(const void* src, long long n,
                                  long long stride_bytes,
                                  long long xyz_offset_bytes, float* out) {
  const char* base = static_cast<const char*>(src) + xyz_offset_bytes;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (long long i = 0; i < n; ++i) {
    const double* p =
        reinterpret_cast<const double*>(base + i * stride_bytes);
    out[i * 3 + 0] = static_cast<float>(p[0]);
    out[i * 3 + 1] = static_cast<float>(p[1]);
    out[i * 3 + 2] = static_cast<float>(p[2]);
  }
}

// Batch packing for the data-parallel registration path: for each of
// n clouds (contiguous float64 [len,3]), drop non-finite rows, convert
// to float32, and write into the zero-padded arena out[n][bucket][3];
// counts[i] receives the number of kept rows.  OpenMP-parallel over
// clouds (the Python loop doing this was ~half the host time of a
// 64-pair serving batch).  Returns the max kept count (<= bucket), or
// -1 if any cloud overflows the bucket.
long long se3io_pack_pairs(const double* const* ptrs,
                           const long long* lens, long long n,
                           long long bucket, float* out,
                           int* counts) {
  long long max_count = 0;
  long long overflow = 0;
#ifdef _OPENMP
#pragma omp parallel for reduction(max : max_count) \
    reduction(+ : overflow) schedule(dynamic)
#endif
  for (long long i = 0; i < n; ++i) {
    const double* src = ptrs[i];
    float* dst = out + i * bucket * 3;
    long long kept = 0;
    const long long len = lens[i];
    for (long long r = 0; r < len && kept < bucket; ++r) {
      const double x = src[r * 3 + 0];
      const double y = src[r * 3 + 1];
      const double z = src[r * 3 + 2];
      // finite check without <cmath>: NaN != NaN; inf overflows f32
      if (!(x - x == 0.0 && y - y == 0.0 && z - z == 0.0)) continue;
      dst[kept * 3 + 0] = static_cast<float>(x);
      dst[kept * 3 + 1] = static_cast<float>(y);
      dst[kept * 3 + 2] = static_cast<float>(z);
      ++kept;
    }
    if (kept >= bucket && len > bucket) overflow += 1;
    std::memset(dst + kept * 3, 0,
                sizeof(float) * 3 * (bucket - kept));
    counts[i] = static_cast<int>(kept);
    if (kept > max_count) max_count = kept;
  }
  return overflow ? -1 : max_count;
}

}  // extern "C"
