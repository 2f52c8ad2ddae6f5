"""The port's nemeses (`jepsen_tpu_torch.nemesis`, `net`): every case
of tests/test_nemesis.py and of tests/test_nemesis_combined.py, its
membership cases included, run on the port."""

import torch_mirror

globals().update(torch_mirror.cases("test_nemesis"))
globals().update(torch_mirror.cases("test_nemesis_combined"))
