"""The port's serving path on the CPU: the text encoder against the JAX
package, the Server's responses, its HTTP front end and command line
against the JAX server's (`tests/test_cli.py::test_serve_cli`), the
trainer's JAX command line, and the rule that the port (and chip_smoke.py)
import nothing of JAX."""

import functools
import json
import shlex
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.text.encoder import HashTextEncoder as JHashTextEncoder
from text2protein_tpu.text.encoder import (
    build_text_encoder as j_build_text_encoder,
)
from text2protein_tpu_torch import resolve_device
from text2protein_tpu_torch.cli import train as ttrain
from text2protein_tpu_torch.cli.serve import (
    Server,
    build_parser,
    checkpoint_slot,
    decode_coords,
    http_server_from_args,
    make_http_server,
)
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.data.helix_records import write_records
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
        assert health["step"] is None and health["platform"] == "cpu"
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
    assert {"text2protein_tpu_torch.parallel.mesh",
            "text2protein_tpu_torch.parallel.launch",
            "text2protein_tpu_torch.graft_entry",
            "text2protein_tpu_torch.models.normalization",
            "text2protein_tpu_torch.utils.plotting"} <= set(mods)
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


@pytest.mark.parametrize("kind,plan,want", [
    # the N=256 AttnBlock 32x32 forward at B=4: S once (4.3 GFLOP), P V
    # split in two (8.6)
    ("fwd", {"rows": 64, "tile": 32, "chunks": 1},
     2 * 4 * 1024 * 1024 * (512 + 2 * 512)),
    # its backward at B=8: dq S and dP once, dQ split; dkdv S^T and dP^T
    # per column chunk (2), dK and dV split
    ("bwd", {"dq_rows": 64, "dq_tile": 16, "dq_chunks": 1, "dkdv_rows": 64,
             "dkdv_tile": 16, "dkdv_chunks": 2},
     2 * 8 * 1024 * 1024 * (2 * 512 + 2 * 512)
     + 2 * 8 * 1024 * 1024 * (2 * 512 * 2 + 4 * 512)),
])
def test_chip_smoke_route_bound_counts_the_issued_mma_work(kind, plan,
                                                            want):
    """chip_smoke.py's route bound counts the mma work the bf16 kernels
    issue, from their launch plan (no GPU needed)."""
    import chip_smoke

    b = 4 if kind == "fwd" else 8
    assert chip_smoke.bf16_mma_flops(kind, b, 1, 1024, 1024, 512,
                                     plan) == want


def test_chip_smoke_route_bound_pads_ragged_tiles():
    """Ragged Tq and Tk are padded to the blocks' rows and the inner tile,
    and D to 16 (S) and to 64-column boxes (the products with P)."""
    import chip_smoke

    plan = {"rows": 128, "tile": 64, "chunks": 1}
    got = chip_smoke.bf16_mma_flops("fwd", 3, 2, 24, 40, 8, plan)
    assert got == 2 * 3 * 2 * 128 * 64 * (16 + 2 * 64)


# ----------------------------------------------- the JAX server's command line

WAIT_S = 300  # the limit of every wait on the server


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny config trained for 2 steps by the trainer's JAX command line
    (the config positional): (config path, workdir)."""
    tmp = tmp_path_factory.mktemp("serve_cli")
    write_records(tmp / "rec", 41, lengths=(9, N))
    cfg = tiny_config_dict()
    cfg["training"].update({"batch_size": 2, "eval_freq": 1})
    cfg["data"]["min_res_num"] = 4
    path = tmp / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    res = ttrain.main([str(path), "--data", str(tmp / "rec"), "--max_steps",
                       "2", "--device", "cpu", "--workdir_root",
                       str(tmp / "training")])
    return path, Path(res["workdir"])


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=WAIT_S) as r:
        return json.load(r)


def _post(base, payload):
    req = urllib.request.Request(
        f"{base}/v1/sample", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return json.load(r)


def _jax_healthz():
    """The payload of the JAX server's GET /healthz handler, run on a stub
    server (no model)."""
    from text2protein_tpu.cli import serve as jserve

    sent = {}
    handler = object.__new__(jserve._Handler)
    handler.path = "/healthz"
    handler.server_obj = SimpleNamespace(step=2, platform="cpu", b=2, n=N,
                                         config=SimpleNamespace(
                                             sampling={"method": "pc"}))
    handler._send = lambda code, payload: sent.update(payload)
    jserve._Handler.do_GET(handler)
    return sent


def test_serve_cli(trained, monkeypatch):
    """The counterpart of the JAX `test_serve_cli`, from the JAX argv (the
    slot named without `.pt`): /healthz answers the JAX handler's payload;
    two concurrent requests make one batch; a seeded request gives the
    same map with concurrent traffic as alone; a realized request has a
    CA atom per residue; a length out of range gets HTTP 400."""
    from text2protein_tpu_torch.realize import minimize

    # the torsion protocol, 2 restarts of 3 iterations: the Cartesian
    # protocol's failing linesearches on these noise maps take a minute
    monkeypatch.setattr(minimize, "realize_6d_sample", functools.partial(
        minimize.realize_6d_sample, n_restarts=2, max_iter=3,
        method="torsion"))
    cfg, wd = trained
    args = build_parser().parse_args([
        str(cfg), str(wd / "checkpoints" / "best_eval"), "--batch_size", "2",
        "--num_steps", "4", "--port", "0", "--realize", "--max_wait_ms",
        "200", "--device", "cpu"])
    httpd = http_server_from_args(args)
    server = httpd.RequestHandlerClass.worker.server
    batches = []
    run_batch = server.run_batch

    def counted(reqs):
        batches.append([r.get("caption") for r in reqs])
        return run_batch(reqs)

    server.run_batch = counted
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        health = _get(base, "/healthz")
        assert health == _jax_healthz()
        assert health["step"] == 2 and health["max_res_num"] == N

        lengths = (12, 10)
        results = [None, None]
        ready = threading.Barrier(2)

        def client(i):
            ready.wait(WAIT_S)
            results[i] = _post(base, {"caption": f"helix {i}",
                                      "length": lengths[i]})

        clients = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(WAIT_S)
        assert len(batches) == 1 and len(batches[0]) == 2
        assert results[0]["seed"] == results[1]["seed"]
        for res, L in zip(results, lengths):
            cnn = decode_coords(res)
            assert cnn.shape == (C, N, N) and np.isfinite(cnn).all()
            assert cnn[-1][:L, :L].min() == 1.0
            assert cnn[-1].sum() == L * L
            assert res["nfe"] == 8

        seeded = {"caption": "helix", "length": 12, "seed": 7}
        alone = _post(base, seeded)
        noise = threading.Thread(
            target=_post, args=(base, {"caption": "noise", "length": 9}),
            daemon=True)
        noise.start()
        again = _post(base, seeded)
        noise.join(WAIT_S)
        assert alone["seed"] == again["seed"] == 7
        np.testing.assert_array_equal(decode_coords(alone),
                                      decode_coords(again))

        item = _post(base, {"caption": "helix", "length": 10,
                            "realize": True})
        ca = [ln for ln in item["pdb"].splitlines()
              if ln.startswith("ATOM") and ln[12:16].strip() == "CA"]
        assert len(ca) == 10 and np.isfinite(item["energy"])

        bad = urllib.request.Request(
            f"{base}/v1/sample", data=json.dumps({"length": 9999}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=WAIT_S)
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=WAIT_S)
    assert not thread.is_alive()


def test_serve_warmup_prints_its_line(trained, capsys):
    cfg, _ = trained
    args = build_parser().parse_args([
        str(cfg), "--batch_size", "1", "--num_steps", "1", "--port", "0",
        "--warmup", "--device", "cpu"])
    httpd = http_server_from_args(args)
    httpd.server_close()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("warmup batch done in ")
    assert out[0].endswith("s")
    assert out[1].startswith("serving random weights (seed 0) on "
                             f"http://127.0.0.1:{httpd.server_address[1]} ")
    assert httpd.RequestHandlerClass.worker.batches == 1  # its thread


def test_serve_module_answers_then_stops_on_sigint(trained):
    """`python -m text2protein_tpu_torch.cli.serve <config> <checkpoint>`
    as a process: it announces its port, answers, and on SIGINT prints the
    batches it ran and the flash launches (none on the CPU: the plain
    versions run there) and exits 0."""
    cfg, wd = trained
    proc = subprocess.Popen(
        [sys.executable, "-m", "text2protein_tpu_torch.cli.serve", str(cfg),
         str(wd / "checkpoints" / "best_eval"), "--batch_size", "2",
         "--num_steps", "2", "--port", "0", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving step-2 model on http://"), line
        base = line.split()[4]
        res = _post(base, {"caption": "helix", "length": 11, "seed": 3})
        assert decode_coords(res).shape == (C, N, N)
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=WAIT_S)
    finally:
        proc.kill()
        proc.wait(WAIT_S)
    assert proc.returncode == 0, out
    assert out.splitlines()[-1] == (
        "stopped after 1 batches; flash launches: forward 0 f32, 0 bf16; "
        "backward 0 f32, 0 bf16")


def test_checkpoint_slot_follows_the_jax_rule(tmp_path):
    """The workdir is the slot's parent's parent and the slot the path, or
    the path with `.pt` (the JAX package's slot names have no suffix), or
    else the workdir's first slot; a directory is the workdir."""
    wd = tmp_path / "run"
    best = wd / "checkpoints" / "best_eval.pt"
    best.parent.mkdir(parents=True)
    best.write_bytes(b"")
    assert checkpoint_slot(wd / "checkpoints" / "best_eval") == (wd, best)
    assert checkpoint_slot(best) == (wd, best)
    assert checkpoint_slot(wd) == (wd, None)
    assert checkpoint_slot(wd / "checkpoints" / "best_train") == (wd, None)


def _readme_commands(module):
    """The argv of every `python -m text2protein_tpu.cli.<module>` command
    of the README."""
    text = (REPO / "README.md").read_text().replace("\\\n", " ")
    prefix = f"python -m text2protein_tpu.cli.{module} "
    return [shlex.split(line.split(prefix, 1)[1])
            for line in text.splitlines() if prefix in line]


@pytest.mark.parametrize("module", ["serve", "train"])
def test_readme_jax_command_lines_parse_in_the_port(module):
    """Each JAX command line of the README, the module name changed, parses
    in the port to the JAX parser's values."""
    from text2protein_tpu.cli import serve as jserve
    from text2protein_tpu.cli import train as jtrain

    parsers = {"serve": (jserve.build_parser, build_parser),
               "train": (jtrain.build_argparser, ttrain.build_argparser)}
    jparser, pparser = (make() for make in parsers[module])
    commands = _readme_commands(module)
    assert commands
    for argv in commands:
        want = vars(jparser.parse_args(argv))
        got = vars(pparser.parse_args(argv))
        assert {k: got[k] for k in want} == want, argv


@pytest.mark.parametrize("parser", [build_parser, ttrain.build_argparser])
def test_config_given_both_ways_is_an_error(parser, capsys):
    with pytest.raises(SystemExit):
        parser().parse_args(["a.yml", "--config", "a.yml"])
    assert "config given both" in capsys.readouterr().err
    assert parser().parse_args(["--config", "a.yml"]).config == "a.yml"
    assert parser().parse_args([]).config is None


def test_serve_checkpoint_given_both_ways_is_an_error():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["a.yml", "w", "--checkpoint", "w"])
    args = build_parser().parse_args(["--checkpoint", "w", "a.yml"])
    assert (args.config, args.checkpoint) == ("a.yml", "w")


def test_train_local_test_caps_the_batch_and_the_records(tmp_path):
    """`--local_test`, as the JAX trainer takes it: training.batch_size
    capped at 2, the dataset cut to its first 200 records."""
    write_records(tmp_path / "rec", 203, lengths=(9, N))
    cfg = tiny_config_dict()
    cfg["training"].update({"batch_size": 4, "eval_freq": 100})
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    res = ttrain.main([str(path), "--local_test", "--data",
                       str(tmp_path / "rec"), "--max_steps", "1", "--device",
                       "cpu", "--workdir_root", str(tmp_path / "training")])
    wd = Path(res["workdir"])
    assert res["records"] == 200
    assert load_config(str(wd / "config.yml")).training.batch_size == 2
    ids = sorted((wd / "train_ids.txt").read_text().split()
                 + (wd / "test_ids.txt").read_text().split())
    names = sorted(p.name.split(".")[0] for p in (tmp_path / "rec").iterdir())
    assert ids == names[:200]
