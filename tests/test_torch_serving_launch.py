"""``python -m repro_torch.launch.serve --serve-maps`` as a user runs it: both
frontends boot from the default flags (the asyncio one, and the threaded one
with ``--no-async``), print their URL on the first line, answer
``GET /healthz`` and ``POST /v1/evaluate``, and exit 0 on SIGINT.  On a
machine without a card (``CUDA_VISIBLE_DEVICES`` empty) an evaluate that
does not say ``"interpret": true`` answers the kernels' NO_CARD error, and
with it answers the exact coordinates.  (``--backend engine`` is held in
``tests/test_torch_engine.py``.)"""
import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np

from repro_torch.core.maps import np_map
from repro_torch.kernels.domain_map.kernel import NO_CARD

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _post(url: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(
        url + "/v1/evaluate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_serve_maps_boots_both_frontends(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC),
           "CUDA_VISIBLE_DEVICES": "",
           "REPRO_ARTIFACT_CACHE": str(tmp_path / "store"),
           "REPRO_WIRE_CACHE_ENTRIES": "7",
           "REPRO_ROUTER_POLICY": "static"}
    procs = {mode: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--serve-maps",
         "--port", "0", *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mode, extra in (("async", []), ("threaded", ["--no-async"]))}
    try:
        for mode, proc in procs.items():
            first = proc.stdout.readline()
            assert first.startswith("mapping service on http://"), (
                first, proc.stderr.read() if proc.poll() is not None else "")
            assert f"frontend={mode}" in first and "backend=mock" in first
            url = first.split()[3]
            banner = [first]
            while not banner[-1].startswith("endpoints:"):
                banner.append(proc.stdout.readline())
            assert "response LRU=7 entries" in "".join(banner)
            assert "router: policy=static" in "".join(banner)
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
            assert health["status"] == "ok" and health["mode"] == mode

            query = {"domain": "tri2d", "n_points": 300, "start": 5}
            status, payload = _post(url, query)
            assert status == 500
            assert payload["error"] == f"RuntimeError: {NO_CARD}"
            status, payload = _post(url, {**query, "interpret": True})
            assert status == 200 and payload["interpret"] is True
            np.testing.assert_array_equal(
                np.asarray(payload["coords"], dtype=np.int64),
                np_map("tri2d", np.arange(5, 305, dtype=np.int64)))
        for mode, proc in procs.items():
            proc.send_signal(signal.SIGINT)
            _, err = proc.communicate(timeout=60)
            assert proc.returncode == 0, (mode, err)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
