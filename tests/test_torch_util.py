"""The port's `util` and `history` (relative time, `real_pmap`, the
history helpers, the op builders and `History`'s filters): every case
of tests/test_util.py and tests/test_history.py, run on the port."""

import torch_mirror

globals().update(torch_mirror.cases("test_util"))
globals().update(torch_mirror.cases("test_history"))
