"""Real multi-process test of the multi-host DP path: 2 processes x 2
virtual CPU devices, Gloo collectives -- the same cross-process SPMD
machinery a multi-host deployment uses."""

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_pairs_mesh():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "multihost_worker.py")
    port = str(_free_port())
    env = dict(os.environ)
    # children configure their own platform/devices
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", port, repo],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for pid in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=850)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    # both processes must report the SAME full result list, all within
    # the reference success bounds
    errs = {}
    for out in outs:
        m = re.search(r"RESULT(\d):(\[.*\])", out)
        assert m, out[-3000:]
        errs[m.group(1)] = json.loads(m.group(2))
    np.testing.assert_allclose(errs["0"], errs["1"], atol=1e-12)
    for rot, tra in errs["0"]:
        assert rot < 2.0 and tra < 0.25, (rot, tra)
