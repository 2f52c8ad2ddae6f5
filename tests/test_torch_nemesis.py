"""The port's nemeses (`jepsen_tpu_torch.nemesis`, `net`): every case
of tests/test_nemesis.py and of tests/test_nemesis_combined.py up to its
membership cases (the membership nemesis is not ported yet), run on the
port."""

import torch_mirror

globals().update(torch_mirror.cases("test_nemesis"))
globals().update(torch_mirror.cases("test_nemesis_combined",
                                    cut="class CounterState",
                                    drop=("membership",)))
