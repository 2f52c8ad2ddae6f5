// bump_time: one-shot wall-clock jump.
//
// Host-native C++ port of the behavior of the reference's
// jepsen/resources/bump-time.c (53 LoC C): shift the system wall clock
// by <delta> milliseconds via settimeofday(2), then print the resulting
// wall-clock time as "<sec>.<usec>" so the caller can compute offsets.
//
// Usage: bump_time <delta-ms>     (delta may be negative / fractional)
// Exit:  0 ok, 1 usage/gettimeofday error, 2 settimeofday error (needs
//        root and a real clock — not valid inside containers).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <sys/time.h>

namespace {

constexpr std::int64_t kUsecPerSec = 1'000'000;

// Normalize tv_usec into [0, 1e6).
void normalize(timeval &tv) {
  while (tv.tv_usec < 0) {
    tv.tv_sec -= 1;
    tv.tv_usec += kUsecPerSec;
  }
  while (tv.tv_usec >= kUsecPerSec) {
    tv.tv_sec += 1;
    tv.tv_usec -= kUsecPerSec;
  }
}

}  // namespace

int main(int argc, char **argv) {
  if (argc < 2) {
    std::fprintf(stderr, "usage: %s <delta-ms>\n", argv[0]);
    return 1;
  }

  const auto delta_us =
      static_cast<std::int64_t>(std::atof(argv[1]) * 1000.0);

  timeval now{};
  if (gettimeofday(&now, nullptr) != 0) {
    std::perror("gettimeofday");
    return 1;
  }

  now.tv_sec += delta_us / kUsecPerSec;
  now.tv_usec += delta_us % kUsecPerSec;
  normalize(now);

  if (settimeofday(&now, nullptr) != 0) {
    std::perror("settimeofday");
    return 2;
  }

  if (gettimeofday(&now, nullptr) != 0) {
    std::perror("gettimeofday");
    return 1;
  }
  std::printf("%lld.%06lld\n", static_cast<long long>(now.tv_sec),
              static_cast<long long>(now.tv_usec));
  return 0;
}
