// Standalone microbench for the host merge primitives in fastaparse.cpp.
// Build + run:
//   g++ -O3 -march=native -std=c++17 -pthread -o bench_out/bench_merge \
//       bench_merge.cpp -lz && bench_out/bench_merge
//
// Includes the implementation directly (anonymous-namespace internals).
#include <chrono>
#include <cstdio>
#include <random>

#include "fastaparse.cpp"

using Clock = std::chrono::steady_clock;

static double secs(Clock::time_point a, Clock::time_point b) {
  return std::chrono::duration<double>(b - a).count();
}

int main() {
  std::mt19937_64 rng(42);
  const int64_t N = 8 << 20;

#if defined(__AVX512F__)
  // 1) Raw 2-way SIMD merge: two sorted 4M u64 arrays.
  {
    std::vector<uint64_t> a(N / 2), b(N / 2), out(N);
    for (auto& x : a) x = rng() >> 22;
    for (auto& x : b) x = rng() >> 22;
    std::sort(a.begin(), a.end());
    std::sort(b.begin(), b.end());
    double best = 1e9;
    for (int r = 0; r < 5; r++) {
      auto t0 = Clock::now();
      simd_merge2(a.data(), (int64_t)a.size(), b.data(), (int64_t)b.size(),
                  out.data());
      best = std::min(best, secs(t0, Clock::now()));
    }
    for (int64_t i = 1; i < N; i++)
      if (out[i - 1] > out[i]) {
        printf("simd_merge2 UNSORTED at %ld\n", (long)i);
        return 1;
      }
    printf("simd_merge2 u64 flat:   %7.1f Melem/s\n", N / best / 1e6);
  }
  // 2) Raw 2-way scalar branchless merge, same data.
  {
    std::vector<uint64_t> a(N / 2), b(N / 2), out(N);
    for (auto& x : a) x = rng() >> 22;
    for (auto& x : b) x = rng() >> 22;
    std::sort(a.begin(), a.end());
    std::sort(b.begin(), b.end());
    double best = 1e9;
    for (int r = 0; r < 5; r++) {
      auto t0 = Clock::now();
      scalar_merge2(a.data(), a.data() + a.size(), b.data(),
                    b.data() + b.size(), out.data());
      best = std::min(best, secs(t0, Clock::now()));
    }
    printf("scalar_merge2 u64 flat: %7.1f Melem/s\n", N / best / 1e6);
  }
#endif

  // 3) Full single-thread row merge at the production shapes, tree vs
  //    ladder (bypasses kp_compact_rows' partitioning/threading).
  for (int64_t m : {512, 2048}) {
    const int64_t rows = N / m;
    std::vector<uint64_t> codes(N);
    for (auto& x : codes) x = rng() & ((1ull << 42) - 1);
    std::vector<uint16_t> hi(N);
    std::vector<uint32_t> lo(N);
    for (int64_t r = 0; r < rows; r++)
      std::sort(codes.data() + r * m, codes.data() + (r + 1) * m);
    for (int64_t i = 0; i < N; i++) {
      hi[i] = (uint16_t)(codes[i] >> 32);
      lo[i] = (uint32_t)codes[i];
    }
    std::vector<MergeStream> ss(rows);
    for (int64_t r = 0; r < rows; r++) ss[r] = {r * m, (r + 1) * m};
    std::vector<uint64_t> oc(N);
    std::vector<int64_t> on(N);

    auto bench = [&](const char* name, auto fn) {
      double best = 1e9;
      int64_t len = 0;
      for (int r = 0; r < 3; r++) {
        auto s2 = ss;
        auto t0 = Clock::now();
        len = fn(s2);
        best = std::min(best, secs(t0, Clock::now()));
      }
      printf("%-22s m=%5ld: %7.1f Melem/s (out %ld)\n", name, (long)m,
             N / best / 1e6, (long)len);
    };
    bench("loser_tree(2stage)", [&](std::vector<MergeStream>& s2) {
      return merge_two_stage<2>(s2, hi.data(), lo.data(), oc.data(),
                                on.data());
    });
#if defined(__AVX512F__)
    bench("merge_ladder", [&](std::vector<MergeStream>& s2) {
      return merge_ladder<2>(s2, hi.data(), lo.data(), oc.data(), on.data());
    });
#endif
  }

  // 4) LSD radix compact prototype: sortedness-free — widen, 3x14-bit
  //    counting-sort passes, RLE. If this wins, the device need not sort.
  {
    const int64_t kBits = 42;
    std::vector<uint64_t> codes(N);
    for (auto& x : codes) x = rng() & ((1ull << kBits) - 1);
    std::vector<uint16_t> hi(N);
    std::vector<uint32_t> lo(N);
    for (int64_t i = 0; i < N; i++) {
      hi[i] = (uint16_t)(codes[i] >> 32);
      lo[i] = (uint32_t)codes[i];
    }
    auto huge_alloc = [](int64_t n) -> uint64_t* {
      void* p = nullptr;
      if (posix_memalign(&p, 2 << 20, n * sizeof(uint64_t))) return nullptr;
#ifdef MADV_HUGEPAGE
      madvise(p, n * sizeof(uint64_t), MADV_HUGEPAGE);
#endif
      return static_cast<uint64_t*>(p);
    };
    uint64_t* b0 = huge_alloc(N);
    uint64_t* b1 = huge_alloc(N);
    memset(b0, 0, N * 8);
    memset(b1, 0, N * 8);  // pre-fault
    std::vector<uint64_t> oc(N);
    std::vector<int64_t> on(N);
    auto radix_compact = [&](int kDigit) -> int64_t {
      for (int64_t i = 0; i < N; i++)
        b0[i] = ((uint64_t)hi[i] << 32) | lo[i];
      const int64_t B = 1ll << kDigit;
      std::vector<int64_t> cnt(B);
      uint64_t* src = b0;
      uint64_t* dst = b1;
      for (int shift = 0; shift < kBits; shift += kDigit) {
        std::fill(cnt.begin(), cnt.end(), 0);
        const uint64_t mask = B - 1;
        for (int64_t i = 0; i < N; i++) cnt[(src[i] >> shift) & mask]++;
        int64_t acc = 0;
        for (int64_t b = 0; b < B; b++) {
          int64_t c = cnt[b];
          cnt[b] = acc;
          acc += c;
        }
        for (int64_t i = 0; i < N; i++) dst[cnt[(src[i] >> shift) & mask]++] = src[i];
        std::swap(src, dst);
      }
      return rle_run(src, N, oc.data(), on.data());
    };
    for (int kDigit : {8, 11, 14}) {
    double best = 1e9;
    int64_t len = 0;
    for (int r = 0; r < 3; r++) {
      auto t0 = Clock::now();
      len = radix_compact(kDigit);
      best = std::min(best, secs(t0, Clock::now()));
    }
    // verify
    std::vector<uint64_t> sorted(codes);
    std::sort(sorted.begin(), sorted.end());
    bool ok = true;
    int64_t w = 0, i = 0;
    while (i < N) {
      int64_t j = i;
      while (j < N && sorted[j] == sorted[i]) j++;
      if (w >= len || oc[w] != sorted[i] || on[w] != j - i) {
        ok = false;
        break;
      }
      w++;
      i = j;
    }
    printf("radix_compact 42b d=%-2d: %7.1f Melem/s (out %ld, %s)\n", kDigit,
           N / best / 1e6, (long)len, ok && w == len ? "OK" : "MISMATCH");
    }
    free(b0);
    free(b1);

    // 5) The production MSD+LSD radix compactor (kp_compact_unsorted),
    //    single- and multi-threaded as num_threads decides.
    {
      std::vector<uint64_t> oc2(N);
      std::vector<int64_t> on2(N);
      double best = 1e9;
      int64_t len = 0;
      for (int r = 0; r < 3; r++) {
        auto t0 = Clock::now();
        len = kp_compact_unsorted(hi.data(), 2, lo.data(), N, 42, oc2.data(),
                                  on2.data());
        best = std::min(best, secs(t0, Clock::now()));
      }
      std::vector<uint64_t> sorted(codes);
      std::sort(sorted.begin(), sorted.end());
      bool ok = true;
      int64_t w = 0, i = 0;
      while (i < N) {
        int64_t j = i;
        while (j < N && sorted[j] == sorted[i]) j++;
        if (w >= len || oc2[w] != sorted[i] || on2[w] != j - i) {
          ok = false;
          break;
        }
        w++;
        i = j;
      }
      printf("kp_compact_unsorted:    %7.1f Melem/s (out %ld, %s)\n",
             N / best / 1e6, (long)len, ok && w == len ? "OK" : "MISMATCH");
    }

    // 6) Phase isolation (single thread): LSD on one bucket, RLE, hist.
    {
      const int64_t BL = N / 256;
      std::vector<uint64_t> bucket(BL), scr(BL);
      for (auto& x : bucket) x = rng() & ((1ull << 34) - 1);
      double best = 1e9;
      for (int r = 0; r < 5; r++) {
        std::vector<uint64_t> b2(bucket);
        auto t0 = Clock::now();
        lsd_radix(b2.data(), scr.data(), BL, 34);
        best = std::min(best, secs(t0, Clock::now()));
      }
      printf("lsd_radix 34b/32K:      %7.1f Melem/s\n", BL / best / 1e6);
      // Digit-width sweep for the in-bucket LSD: fewer dst streams keep
      // the scatter's store lines L1-resident at the cost of more passes.
      // MEASURED DEAD END (2026-08-19, bucket-size sweep 32K..8M u64):
      // digits 9-11 win only at L2-resident bucket sizes and only by ~5%
      // (within this VM's noise); at >= 256K elements the 12-bit 3-pass
      // choice wins by 10-40% (DRAM sweeps dominate, fewer passes win).
      // RadixTraits' 12-bit default stands; no adaptive digit needed.
      for (int dig : {7, 8, 9, 10, 11}) {
        auto lsd_d = [&](uint64_t* buf, uint64_t* s, int64_t n, int bits) {
          std::vector<uint32_t> cnt(1 << dig);
          uint64_t* src = buf;
          uint64_t* dst = s;
          for (int shift = 0; shift < bits; shift += dig) {
            const int d = std::min(dig, bits - shift);
            const uint64_t mask = (1ull << d) - 1;
            memset(cnt.data(), 0, (1u << d) * sizeof(uint32_t));
            for (int64_t i = 0; i < n; i++) cnt[(src[i] >> shift) & mask]++;
            uint32_t acc2 = 0;
            for (int64_t b = 0; b < (1 << d); b++) {
              uint32_t c = cnt[b];
              cnt[b] = acc2;
              acc2 += c;
            }
            for (int64_t i = 0; i < n; i++)
              dst[cnt[(src[i] >> shift) & mask]++] = src[i];
            std::swap(src, dst);
          }
          return src;
        };
        double bd = 1e9;
        for (int r = 0; r < 5; r++) {
          std::vector<uint64_t> b2(bucket);
          auto t0 = Clock::now();
          lsd_d(b2.data(), scr.data(), BL, 34);
          bd = std::min(bd, secs(t0, Clock::now()));
        }
        printf("lsd digit=%-2d 34b/32K:   %7.1f Melem/s\n", dig,
               BL / bd / 1e6);
      }
      // u32 in-bucket LSD (the double-MSD plan's inner sort): same element
      // count, half the traffic.
      {
        std::vector<uint32_t> b32(BL), s32(BL);
        for (int64_t i = 0; i < BL; i++) b32[i] = (uint32_t)(rng() & ((1u << 28) - 1));
        double b28 = 1e9;
        for (int r = 0; r < 5; r++) {
          std::vector<uint32_t> b2(b32);
          auto t0 = Clock::now();
          lsd_radix(b2.data(), s32.data(), BL, 28);
          b28 = std::min(b28, secs(t0, Clock::now()));
        }
        printf("lsd_radix u32 28b/32K:  %7.1f Melem/s\n", BL / b28 / 1e6);
      }
      std::vector<uint64_t> big(N);
      for (auto& x : big) x = rng();
      std::sort(big.begin(), big.end());
      std::vector<uint64_t> oc3(N);
      std::vector<int64_t> on3(N);
      best = 1e9;
      for (int r = 0; r < 3; r++) {
        auto t0 = Clock::now();
        rle_run(big.data(), N, oc3.data(), on3.data());
        best = std::min(best, secs(t0, Clock::now()));
      }
      printf("rle_run 8M:             %7.1f Melem/s\n", N / best / 1e6);
    }
  }
  return 0;
}
