// strobe_time_experiment: phase-locked wall-clock strobing.
//
// Host-native C++ port of the *intent* of the reference's
// jepsen/resources/strobe-time-experiment.c (205 LoC C). That file is
// an abandoned draft: it builds tick-alignment machinery (next_tick /
// sleep_until_next_tick anchored to CLOCK_MONOTONIC) but its main()
// never calls it, and the file does not compile (a stray token in
// timespec_to_nanos, `null` for NULL). This port finishes the idea:
// unlike the shipped strobe_time, which sleeps a *relative* period
// between flips and therefore drifts by the per-iteration overhead,
// this variant sleeps until the next absolute tick anchor + n*period
// on the monotonic clock, so flip edges stay phase-locked over long
// durations — the property the experiment was reaching for.
//
// Usage: strobe_time_experiment <delta-ms> <period-ms> <duration-s>
// Exit:  0 ok, 1 usage, 2 settimeofday error, 3 nanosleep error.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <ctime>
#include <sys/time.h>

namespace {

constexpr std::int64_t kNanosPerSec = 1'000'000'000;

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

// Sleep until the next absolute tick anchor + n*period (n integral)
// strictly after "now" — the experiment's next_tick/
// sleep_until_next_tick, collapsed into 64-bit nanosecond arithmetic.
int sleep_until_next_tick(std::int64_t anchor, std::int64_t period) {
  const std::int64_t now = monotonic_nanos();
  const std::int64_t next = now + (period - (now - anchor) % period);
  const std::int64_t delta = next - monotonic_nanos();
  if (delta <= 0) return 0;
  timespec ts{};
  ts.tv_sec = delta / kNanosPerSec;
  ts.tv_nsec = delta % kNanosPerSec;
  timespec rem{};
  return nanosleep(&ts, &rem);
}

}  // namespace

int main(int argc, char **argv) {
  if (argc < 4) {
    std::fprintf(stderr,
                 "usage: %s <delta-ms> <period-ms> <duration-s>\n"
                 "Phase-locked strobe: on every absolute period tick "
                 "of the monotonic clock, toggles the wall clock "
                 "between true time and true time + delta ms, for "
                 "duration seconds; then restores the clock.\n",
                 argv[0]);
    return 1;
  }

  const auto delta = static_cast<std::int64_t>(
      std::atof(argv[1]) * 1'000'000.0);
  const auto period = static_cast<std::int64_t>(
      std::atof(argv[2]) * 1'000'000.0);
  const auto duration = static_cast<std::int64_t>(
      std::atof(argv[3]) * 1'000'000'000.0);
  if (period <= 0) {
    std::fprintf(stderr, "period must be positive\n");
    return 1;
  }

  const std::int64_t true_offset = wall_nanos() - monotonic_nanos();
  const std::int64_t skew_offset = true_offset + delta;
  const std::int64_t anchor = monotonic_nanos();
  const std::int64_t end = anchor + duration;

  bool skewed = false;
  std::int64_t flips = 0;
  while (monotonic_nanos() < end) {
    set_wall_nanos(monotonic_nanos() +
                   (skewed ? true_offset : skew_offset));
    skewed = !skewed;
    ++flips;
    if (sleep_until_next_tick(anchor, period) != 0) {
      std::perror("nanosleep");
      return 3;
    }
  }

  set_wall_nanos(monotonic_nanos() + true_offset);
  std::printf("%lld\n", static_cast<long long>(flips));
  return 0;
}
