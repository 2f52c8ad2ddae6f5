"""Every case of tests/test_db_os.py (DB capabilities and cycles,
tcpdump, the debian and ubuntu OSes, faketime) run on the port over the
dummy remote."""

import torch_mirror

globals().update(torch_mirror.cases("test_db_os"))
