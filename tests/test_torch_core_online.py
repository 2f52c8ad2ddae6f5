"""Online checking through the port's `core.run`: tests/test_streaming.py's
end-to-end cases on the port, on the CPU. The interpreter's journal feeds
the streamed check during the run and `analyze` reuses its verdict; a
run with `abort-on-violation` stops early, its verdict at the op index
that an offline check of the stored history names in both packages; and
the CLI's `--online` reaches the run."""

import random

import pytest
import torch

from jepsen_tpu import models as jmodels
from jepsen_tpu.checker.linear import linearizable as jlinearizable
from jepsen_tpu.history import history as jhistory
from jepsen_tpu_torch import cli, client as jclient, core, models, store
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import testkit
from jepsen_tpu_torch.checker import linearizable

CHUNK = 128


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _atom_test(tmp_path, n=400, **kw):
    state = testkit.AtomState()
    rng = random.Random(45100)
    t = testkit.noop_test()
    t["ssh"] = {"dummy": True}
    t["store-dir"] = str(tmp_path / "store")
    t.update({
        "name": "online smoke",
        "db": testkit.atom_db(state),
        "client": testkit.atom_client(state, latency_s=0.0),
        "concurrency": 5,
        # AtomDB.setup zeroes the cell, so the model starts at 0
        "checker": linearizable(models.cas_register(0), device="cpu"),
        "online": True,
        "online-chunk-entries": CHUNK,
        "generator": gen.clients(gen.limit(n, gen.mix([
            lambda: {"f": "read"},
            lambda: {"f": "write", "value": rng.randint(0, 4)},
            lambda: {"f": "cas", "value": [rng.randint(0, 4),
                                           rng.randint(0, 4)]},
        ]))),
    })
    t.update(kw)
    return t


# the dense stream runs at concurrency 2: its table has 2^(c+4) columns,
# and the CPU's plain closure round is slow at c = 5
@pytest.mark.parametrize("extra,analyzer", [
    ({}, "gpu-wgl-streaming"),
    ({"online-state-range": [-1, 4], "concurrency": 2},
     "gpu-wgl-dense-streaming")])
def test_core_run_online_streams_and_reuses_result(tmp_path, extra,
                                                   analyzer):
    t = core.run(_atom_test(tmp_path, **extra))
    sr = t["streamed-results"]["linear"]
    assert sr["valid?"] is True
    assert sr["streamed"] is True
    # analyze() reused the streamed verdict instead of re-checking
    assert t["results"]["valid?"] is True
    assert t["results"].get("streamed") is True
    assert t["results"]["analyzer"] == analyzer
    # ... and the journal fed the stream (a journal existed: named test)
    assert (tmp_path / "store").exists()
    # the streamed verdict is the offline one on the stored history
    offline = linearizable(models.cas_register(0), device="cpu").check(
        {}, store.load_history(t), {})
    assert offline["valid?"] is True


class _LyingClient(jclient.Client):
    """Returns impossible reads after a warm-up — the violation the
    online checker must catch mid-run."""

    def __init__(self, state, after):
        self.inner = testkit.atom_client(state, latency_s=0.0005)
        self.after = after
        self.count = [0]

    def open(self, test, node):
        c = _LyingClient.__new__(_LyingClient)
        c.inner = self.inner.open(test, node)
        c.after = self.after
        c.count = self.count
        return c

    def setup(self, test):
        self.inner.setup(test)

    def invoke(self, test, op):
        out = self.inner.invoke(test, op)
        self.count[0] += 1
        if self.count[0] > self.after and op["f"] == "read" \
                and out["type"] == "ok":
            out = dict(out)
            out["value"] = 10 ** 6
        return out

    def teardown(self, test):
        self.inner.teardown(test)

    def close(self, test):
        self.inner.close(test)


@pytest.mark.parametrize("srange", [None, [-1, 4]])
def test_core_run_abort_on_violation(tmp_path, srange):
    state = testkit.AtomState()
    n = 20000
    t = _atom_test(tmp_path, n=n, name="abort on violation",
                   client=_LyingClient(state, after=150),
                   db=testkit.atom_db(state))
    if srange:
        t["online-state-range"] = srange
    t["abort-on-violation"] = True
    done = core.run(t)
    assert done.get("aborted-on-violation") is True
    assert len(done["history"]) < 2 * n   # the run stopped early
    r = done["results"]
    assert r["valid?"] is False
    # the stored history, checked offline by each package, fails at the
    # op the streamed verdict names
    stored = store.load_history(done)
    port = linearizable(models.cas_register(0), device="cpu").check(
        {}, stored, {})
    ref = jlinearizable(jmodels.cas_register(0), pallas=True).check(
        {}, jhistory(stored.ops), {})
    assert r["op-index"] == port["op-index"] == ref["op-index"]
    assert port["valid?"] is ref["valid?"] is False


def test_cli_online_end_to_end(tmp_path):
    def test_fn(options):
        t = _atom_test(tmp_path, n=120)
        t["name"] = "cli online"
        t["store-dir"] = options["store-dir"]
        # the CLI flags must have reached the test map
        assert options["online"] is True
        assert options["abort-on-violation"] is True
        assert options["device"] == "cpu"
        t["online"] = options["online"]
        t["abort-on-violation"] = options["abort-on-violation"]
        return t

    cmds = cli.single_test_cmd({"test_fn": test_fn})
    with pytest.raises(SystemExit) as e:
        cli.run(cmds, ["test", "--no-ssh", "--online",
                       "--abort-on-violation", "--device", "cpu",
                       "--store-dir", str(tmp_path / "store")])
    assert e.value.code == 0
    stored = store.load_test(str(tmp_path / "store" / "latest"))
    assert stored["results"]["valid?"] is True
    assert stored["results"].get("streamed") is True
