// strobe_time: oscillate the wall clock around true time.
//
// Host-native C++ port of the behavior of the reference's
// jepsen/resources/strobe-time.c (171 LoC C): every <period> ms, flip
// the wall clock between true time and true time + <delta> ms, for
// <duration> seconds, using CLOCK_MONOTONIC as the undisturbed
// reference; restore the clock and print the number of flips.
//
// Usage: strobe_time <delta-ms> <period-ms> <duration-s>
// Exit:  0 ok, 1 usage, 2 settimeofday error, 3 nanosleep error.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <ctime>
#include <sys/time.h>

namespace {

constexpr std::int64_t kNanosPerSec = 1'000'000'000;

// All arithmetic in signed 64-bit nanoseconds — simpler and less
// error-prone than timespec carry chains for the ranges involved
// (±2^18 ms skews over ≤32 s runs fit comfortably).
std::int64_t to_nanos(const timespec &ts) {
  return static_cast<std::int64_t>(ts.tv_sec) * kNanosPerSec + ts.tv_nsec;
}

std::int64_t monotonic_nanos() {
  timespec ts{};
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return to_nanos(ts);
}

std::int64_t wall_nanos() {
  timeval tv{};
  if (gettimeofday(&tv, nullptr) != 0) {
    std::perror("gettimeofday");
    std::exit(1);
  }
  return static_cast<std::int64_t>(tv.tv_sec) * kNanosPerSec +
         static_cast<std::int64_t>(tv.tv_usec) * 1000;
}

void set_wall_nanos(std::int64_t nanos) {
  timeval tv{};
  tv.tv_sec = nanos / kNanosPerSec;
  tv.tv_usec = (nanos % kNanosPerSec) / 1000;
  if (tv.tv_usec < 0) {
    tv.tv_sec -= 1;
    tv.tv_usec += 1'000'000;
  }
  if (settimeofday(&tv, nullptr) != 0) {
    std::perror("settimeofday");
    std::exit(2);
  }
}

}  // namespace

int main(int argc, char **argv) {
  if (argc < 4) {
    std::fprintf(stderr,
                 "usage: %s <delta-ms> <period-ms> <duration-s>\n"
                 "Every period ms, toggles the wall clock between true "
                 "time and true time + delta ms, for duration seconds; "
                 "then restores the clock. Useful for confusing systems "
                 "that assume clocks are monotonic and linear.\n",
                 argv[0]);
    return 1;
  }

  const auto delta = static_cast<std::int64_t>(
      std::atof(argv[1]) * 1'000'000.0);
  const auto period_ns = static_cast<std::int64_t>(
      std::atof(argv[2]) * 1'000'000.0);
  const auto duration = static_cast<std::int64_t>(
      std::atof(argv[3]) * 1'000'000'000.0);

  // Wall time = monotonic time + offset; the strobe toggles the offset.
  const std::int64_t true_offset = wall_nanos() - monotonic_nanos();
  const std::int64_t skew_offset = true_offset + delta;
  const std::int64_t end = monotonic_nanos() + duration;

  timespec period{};
  period.tv_sec = period_ns / kNanosPerSec;
  period.tv_nsec = period_ns % kNanosPerSec;

  bool skewed = false;
  std::int64_t flips = 0;
  while (monotonic_nanos() < end) {
    set_wall_nanos(monotonic_nanos() +
                   (skewed ? true_offset : skew_offset));
    skewed = !skewed;
    ++flips;
    timespec rem{};
    if (nanosleep(&period, &rem) != 0) {
      std::perror("nanosleep");
      return 3;
    }
  }

  set_wall_nanos(monotonic_nanos() + true_offset);
  std::printf("%lld\n", static_cast<long long>(flips));
  return 0;
}
