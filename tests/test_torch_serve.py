"""The port's serving path on the CPU: the text encoder against the JAX
package, the Server's responses, its HTTP front end, and the rule that the
port (and chip_smoke.py) import nothing of JAX."""

import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.text.encoder import HashTextEncoder as JHashTextEncoder
from text2protein_tpu.text.encoder import (
    build_text_encoder as j_build_text_encoder,
)
from text2protein_tpu_torch import resolve_device
from text2protein_tpu_torch.cli.serve import (
    Server,
    decode_coords,
    make_http_server,
)
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.text.encoder import (
    HashTextEncoder,
    build_text_encoder,
)

from torch_port_helpers import C, N, tiny_config_dict

REPO = Path(__file__).resolve().parents[1]
CAPTIONS = [
    "A small alpha-helical bundle that binds zinc.",
    "",
    "beta barrel; membrane transporter (TonB-dependent)",
    " ".join(f"word{i}" for i in range(150)),
]


@pytest.mark.parametrize("kw", [
    {},
    {"dim": 64, "pad_to_bucket": 8, "seed": 42},
    {"dim": 32, "max_tokens": 16, "vocab_size": 97, "seed": 3},
])
def test_hash_text_encoder_is_bit_equal(kw):
    want = JHashTextEncoder(**kw).encode(CAPTIONS)
    got = HashTextEncoder(**kw).encode(CAPTIONS)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_build_text_encoder_matches_jax():
    cfg = tiny_config_dict()
    want = j_build_text_encoder(j_load_config(cfg)).encode(CAPTIONS[:2])
    got = build_text_encoder(load_config(cfg)).encode(CAPTIONS[:2])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def server():
    return Server(load_config(tiny_config_dict()), batch_size=3,
                  num_steps=3, weight_seed=0, device="cpu")


def _check_response(item, req):
    cnn = decode_coords(item)
    assert cnn.shape == (C, N, N) and cnn.dtype == np.float32
    assert np.isfinite(cnn).all()
    length = req["length"]
    want = np.zeros((N, N), np.float32)
    want[:length, :length] = 1.0
    np.testing.assert_array_equal(cnn[-1], want)
    assert item["length"] == length
    assert item["nfe"] == 3 * 2
    return cnn


def test_run_batch_responses(server):
    reqs = [{"caption": CAPTIONS[0], "length": 9},
            {"caption": CAPTIONS[2], "length": 16}]
    out = server.run_batch(reqs)
    assert len(out) == 2
    for item, req in zip(out, reqs):
        assert set(item) == {"length", "nfe", "seed", "coords_6d_b64"}
        _check_response(item, req)
    assert out[0]["seed"] == out[1]["seed"]


def test_seeded_request_is_reproducible(server):
    req = {"caption": CAPTIONS[0], "length": 12, "seed": 77}
    a = server.run_batch([req])[0]
    b = server.run_batch([req])[0]
    assert a["seed"] == b["seed"] == 77
    np.testing.assert_array_equal(_check_response(a, req),
                                  _check_response(b, req))
    other = server.run_batch([dict(req, seed=78)])[0]
    assert not np.array_equal(decode_coords(other), decode_coords(a))


def test_run_batch_refuses_oversized_batches(server):
    with pytest.raises(ValueError):
        server.run_batch([{"length": 4}] * 4)


def test_weights_file_loads_strictly(server, tmp_path):
    path = tmp_path / "state.pt"
    torch.save(server.model.state_dict(), path)
    loaded = Server(load_config(tiny_config_dict()), batch_size=3,
                    num_steps=3, weights=str(path), device="cpu")
    req = {"caption": "x", "length": 10, "seed": 5}
    np.testing.assert_array_equal(
        decode_coords(loaded.run_batch([req])[0]),
        decode_coords(server.run_batch([req])[0]))
    bad = dict(server.model.state_dict())
    bad.pop("pre_conv.bias")
    torch.save(bad, path)
    with pytest.raises(RuntimeError, match="pre_conv.bias"):
        Server(load_config(tiny_config_dict()), batch_size=3,
               weights=str(path), device="cpu")


def test_http_front_end(server):
    httpd = make_http_server(server, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.load(r)
        assert health["status"] == "ok" and health["max_res_num"] == N
        req = {"caption": "helix", "length": 11, "seed": 3}
        post = urllib.request.Request(
            f"{base}/v1/sample", data=json.dumps(req).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(post, timeout=120) as r:
            _check_response(json.load(r), req)
        bad = urllib.request.Request(
            f"{base}/v1/sample", data=json.dumps({"length": 1}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=60)
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(load_config(tiny_config_dict()), batch_size=1)


_FORBIDDEN = ("jax", "flax", "optax", "orbax", "yaml", "text2protein_tpu")


def _imports_in_clean_process(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import in a clean
    process without pulling in JAX, flax, yaml or the JAX package."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "text2protein_tpu_torch").rglob("*.py"))
    code = "\n".join(f"import {m}" for m in mods + ["chip_smoke"])
    loaded = _imports_in_clean_process(code)
    bad = [m for m in loaded
           if m.split(".")[0] in _FORBIDDEN]
    assert not bad, bad


def test_chip_smoke_fails_without_a_gpu():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
