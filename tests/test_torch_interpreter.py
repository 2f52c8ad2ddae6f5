"""The port's interpreter (`jepsen_tpu_torch.generator.interpreter`):
every case of tests/test_interpreter.py, run on the port."""

import torch_mirror

globals().update(torch_mirror.cases("test_interpreter"))
