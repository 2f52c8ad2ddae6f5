// adj_time: gradual clock slew.
//
// Host-native C++ port of the behavior of the reference's
// cockroachdb/resources/adjtime.c (19 LoC C): ask the kernel to slew
// the wall clock by <delta> milliseconds gradually via adjtime(2) —
// unlike bump_time's discontinuous jump, the clock stays monotonic
// while running fast/slow until the offset is absorbed.
//
// Usage: adj_time <delta-ms>
// Exit:  0 ok, 1 usage, 2 adjtime error (needs root).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <sys/time.h>

int main(int argc, char **argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <delta-ms>\n", argv[0]);
    return 1;
  }

  const auto delta_us =
      static_cast<std::int64_t>(std::atof(argv[1]) * 1000.0);

  timeval delta{};
  delta.tv_sec = delta_us / 1'000'000;
  delta.tv_usec = delta_us % 1'000'000;

  timeval remaining{};  // any still-unabsorbed previous adjustment
  if (adjtime(&delta, &remaining) != 0) {
    std::perror("adjtime");
    return 2;
  }
  std::printf("%lld.%06lld\n", static_cast<long long>(remaining.tv_sec),
              static_cast<long long>(remaining.tv_usec));
  return 0;
}
