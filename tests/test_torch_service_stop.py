"""The port's service leaves no stream worker alive after `stop()`.

A worker sets its `done` event in its last steps, before its thread has
released its targets, so a caller that sees every verdict and stops the
service could end the process under a live worker thread: the
interpreter then tore torch down beneath it and aborted at exit
("terminate called without an active exception", rc 134), where the JAX
service's process exits 0. The check runs in a fresh interpreter, as a
CLI run of `chaos` or `search --escalate service` ends, on the CPU.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys, threading
from jepsen_tpu_torch import models, store
from jepsen_tpu_torch.checker import synth
from jepsen_tpu_torch.service import VerificationService, model_spec

# chaos's fixed workload spec (jepsen_tpu_torch/chaos/driver.py)
spec = {"linear": {"kind": "wgl", "model": model_spec(models.cas_register()),
                   "chunk-entries": 64, "slots": 8, "engine": "sort",
                   "frontier": 128, "checkpoint-every": 2}}
svc = VerificationService(adaptive=False, device="cpu")
h = synth.register_history(256, concurrency=3, values=5, seed=45100)
hists = {"register": h, "register-corrupt": synth.corrupt(h, seed=7)}
for name in hists:
    svc.admit(name, spec)
for name, hh in hists.items():
    for op in hh.ops:
        svc.offer(name, json.loads(json.dumps(op,
                                              default=store._json_default)))
for name in hists:
    svc.seal(name)
verdicts = {name: svc.result(name, timeout_s=120.0)["linear"]["valid?"]
            for name in hists}
svc.stop()
alive = [t.name for t in threading.enumerate()
         if t.name.startswith("jepsen-service-") and t.is_alive()]
print(json.dumps({"verdicts": verdicts, "alive": alive}))
"""


def test_no_stream_worker_outlives_stop_and_the_process_exits_0():
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, (p.returncode, p.stderr[-2000:])
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["alive"] == []
    assert out["verdicts"] == {"register": True, "register-corrupt": False}
