"""The port's `test`, `analyze` and `test-all` commands
(`jepsen_tpu_torch.cli`): the JAX package's exit codes (0 valid, 1
invalid, 2 unknown, 254 a bad argument, 255 a crash), `--device`
resolved without a quiet CPU fallback, and run directories that each
package's `load_test` and `analyze` read when the other wrote them."""

import json

import pytest
import torch

from jepsen_tpu import cli as jcli
from jepsen_tpu import client as jclient
from jepsen_tpu import generator as jgen
from jepsen_tpu import store as jstore
from jepsen_tpu import testkit as jtestkit
from jepsen_tpu.checker.linear import linearizable as jlinearizable
from jepsen_tpu.models import cas_register as jcas
from jepsen_tpu.workloads import linearizable_register as jlr
from jepsen_tpu_torch import cli as tcli
from jepsen_tpu_torch import client as tclient
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import store as tstore
from jepsen_tpu_torch import testkit as ttestkit
from jepsen_tpu_torch.checker import UNKNOWN
from jepsen_tpu_torch.checker.linear import linearizable as tlinearizable
from jepsen_tpu_torch.models import cas_register as tcas
from jepsen_tpu_torch.workloads import linearizable_register as tlr

JAX = dict(cli=jcli, client=jclient, gen=jgen, testkit=jtestkit,
           store=jstore, lr=jlr,
           checker=lambda o: jlinearizable(jcas(0), pallas=True))
PORT = dict(cli=tcli, client=tclient, gen=tgen, testkit=ttestkit,
            store=tstore, lr=tlr,
            checker=lambda o: tlinearizable(tcas(0), device=o["device"]))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _liar(pkg):
    """An atom register whose reads after the 30th op see 99, a value no
    one writes."""
    class Liar(pkg["client"].Client):
        def __init__(self, state):
            self.inner = pkg["testkit"].atom_client(state, latency_s=0.0)
            self.n = 0

        def open(self, test, node):
            return self

        def invoke(self, test, op):
            self.n += 1
            out = self.inner.invoke(test, op)
            if op["f"] == "read" and self.n > 30:
                out["value"] = 99
            return out

        def reusable(self, test):
            return True
    return Liar


def _test_fn(pkg, n=100, lie=False, checker=None):
    def test_fn(options):
        gen, testkit, lr = pkg["gen"], pkg["testkit"], pkg["lr"]
        state = testkit.AtomState(None)
        client = (_liar(pkg)(state) if lie
                  else testkit.atom_client(state, latency_s=0.0))
        with gen.fixed_rng(5):
            return {**options, "name": "cli-register",
                    "db": testkit.atom_db(state), "client": client,
                    "checker": (checker or pkg["checker"])(options),
                    "generator": gen.clients(gen.limit(
                        n, gen.mix([lr.r, lr.w, lr.cas])))}
    return test_fn


def _argv(cmd, store_dir, *extra, device="cpu"):
    return [cmd, "--no-ssh", "--store-dir", str(store_dir),
            "--concurrency", "2", *(["--device", device] if device else []),
            *extra]


def _exit(pkg, cmds, argv):
    with pytest.raises(SystemExit) as ei:
        pkg["cli"].run(cmds, argv)
    return ei.value.code


def _results(pkg, store_dir):
    """The latest run's results.json, without its wall time."""
    with open(pkg["store"].path(pkg["store"].load_test(
            pkg["store"].latest(str(store_dir))), "results.json")) as fh:
        r = json.load(fh)
    r.pop("duration-ms", None)
    return r


def test_test_and_analyze_exit_0_with_the_same_results(tmp_path):
    cmds = tcli.single_test_cmd({"test_fn": _test_fn(PORT)})
    assert _exit(PORT, cmds, _argv("test", tmp_path)) == 0
    first = _results(PORT, tmp_path)
    assert first["valid?"] is True and first["analyzer"]
    assert _exit(PORT, cmds, _argv("analyze", tmp_path)) == 0
    assert _results(PORT, tmp_path) == first


@pytest.mark.parametrize("fn,code", [
    (lambda: _test_fn(PORT, lie=True), 1),
    (lambda: _test_fn(PORT, checker=lambda o: (
        lambda t, h, opts: {"valid?": UNKNOWN})), 2),
])
def test_test_exits_with_the_verdicts_code(tmp_path, fn, code):
    cmds = tcli.single_test_cmd({"test_fn": fn()})
    assert _exit(PORT, cmds, _argv("test", tmp_path)) == code


@pytest.mark.parametrize("argv", [
    ["test", "--concurrency", "lots"],
    ["test", "--nodes", "n1,n1"],
    ["test", "--no-such-option"],
    ["nope"],
])
def test_bad_arguments_exit_254(tmp_path, argv):
    cmds = tcli.single_test_cmd({"test_fn": _test_fn(PORT)})
    assert _exit(PORT, cmds, argv + ["--store-dir", str(tmp_path)]) == 254


def test_a_crash_exits_255(tmp_path):
    def boom(options):
        raise RuntimeError("test_fn exploded")
    cmds = tcli.single_test_cmd({"test_fn": boom})
    assert _exit(PORT, cmds, _argv("test", tmp_path)) == 255
    # analyze with nothing stored is a crash too, as in the JAX package
    assert _exit(PORT, tcli.single_test_cmd({"test_fn": _test_fn(PORT)}),
                 _argv("analyze", tmp_path / "empty")) == 255
    assert _exit(JAX, jcli.single_test_cmd({"test_fn": _test_fn(JAX)}),
                 _argv("analyze", tmp_path / "empty", device=None)) == 255


@pytest.mark.parametrize("device", [None, "cuda"])
def test_without_a_card_the_commands_exit_254_and_never_run(
        tmp_path, monkeypatch, capsys, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []

    def test_fn(options):
        ran.append(options)
        return _test_fn(PORT)(options)

    for cmds, cmd in ((tcli.single_test_cmd({"test_fn": test_fn}), "test"),
                      (tcli.single_test_cmd({"test_fn": test_fn}),
                       "analyze"),
                      (tcli.test_all_cmd({"tests_fn": lambda o: [
                          test_fn(o)]}), "test-all")):
        assert _exit(PORT, cmds, _argv(cmd, tmp_path, device=device)) == 254
        assert "no CUDA device" in capsys.readouterr().err
    assert ran == []


def test_the_device_reaches_the_options(tmp_path):
    seen = []

    def test_fn(options):
        seen.append(options["device"])
        return _test_fn(PORT)(options)

    cmds = tcli.single_test_cmd({"test_fn": test_fn})
    assert _exit(PORT, cmds, _argv("test", tmp_path)) == 0
    assert seen == ["cpu"]


@pytest.mark.parametrize("lies,code", [
    ((False, False), 0), ((False, True), 1), ((None,), 255)])
def test_test_all_exit_codes(tmp_path, lies, code):
    def tests_fn(options):
        for i, lie in enumerate(lies):
            if lie is None:
                yield {"nodes": ["n1", "n1"]}   # prepare_test rejects it
                continue
            t = _test_fn(PORT, lie=lie)(options)
            yield {**t, "name": f"all-{i}"}

    cmds = tcli.test_all_cmd({"tests_fn": tests_fn})
    assert _exit(PORT, cmds, _argv("test-all", tmp_path)) == code


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
@pytest.mark.parametrize("lie", [False, True])
def test_each_package_analyzes_the_others_run(tmp_path, writer, reader,
                                              lie):
    w_dev = None if writer is JAX else "cpu"
    r_dev = None if reader is JAX else "cpu"
    code = 1 if lie else 0
    w_cmds = writer["cli"].single_test_cmd(
        {"test_fn": _test_fn(writer, lie=lie)})
    assert _exit(writer, w_cmds, _argv("test", tmp_path,
                                       device=w_dev)) == code
    written = _results(writer, tmp_path)

    stored = reader["store"].load_test(
        reader["store"].latest(str(tmp_path)))
    assert len(stored["history"]) == 200
    r_cmds = reader["cli"].single_test_cmd(
        {"test_fn": _test_fn(reader, lie=lie)})
    # analyze reports its verdict in results.json and exits 0 on any
    # verdict, in both packages
    assert _exit(reader, r_cmds, _argv("analyze", tmp_path,
                                       device=r_dev)) == 0
    reread = _results(reader, tmp_path)
    assert (reread["valid?"], reread.get("op-index")) == \
        (written["valid?"], written.get("op-index"))
    assert reread["valid?"] is (not lie)


def test_the_port_reads_a_jax_run_with_keys_and_numpy_results(tmp_path):
    """A JAX run directory whose history holds `(key, value)` tuples and
    whose results hold numpy scalars (both written through the JAX
    store's `_json_default`) reads back the same in both packages."""
    import numpy as np

    from jepsen_tpu import independent as jind

    ops = [{"type": t, "f": "write", "value": jind.ktuple(k, v),
            "process": p, "time": i, "extra": np.int32(i)}
           for i, (t, k, v, p) in enumerate([
               ("invoke", 0, 1, 0), ("ok", 0, 1, 0),
               ("invoke", 1, 2, 1), ("ok", 1, 2, 1)])]
    test = {"name": "jax-keys", "start-time": "20261017T000000.000000",
            "store-dir": str(tmp_path), "history": ops,
            "results": {"valid?": True, "count": np.int64(4),
                        "rate": np.float32(0.5),
                        "keys": (jind.ktuple(0, 1),)}}
    jstore.save_1(test)
    jstore.save_2(test)
    d = tstore.latest(str(tmp_path))
    port, ref = tstore.load_test(d), jstore.load_test(d)
    assert list(port["history"]) == list(ref["history"])
    assert port["history"][0]["value"] == [0, 1]
    assert port["results"] == ref["results"] == {
        "valid?": True, "count": 4, "rate": 0.5, "keys": [[0, 1]]}
    assert {k: v for k, v in port.items() if k not in ("history",)} == \
        {k: v for k, v in ref.items() if k not in ("history",)}
