"""Sampling server (counterpart of text2protein_tpu/cli/serve.py).

`Server` owns the model and the sampler (`sampling.method`: pc, ode or
hybrid, or `--sampler`) at a fixed batch size; each call
of `run_batch(requests)` encodes the captions, builds the length masks, runs
one trajectory for the batch (padded with copies of the last request) and
returns one response per request, with the same fields as the JAX server:
{"length", "nfe", "seed", "coords_6d_b64"} where `coords_6d_b64` is a base64
npz holding "coords_6d", the (C, N, N) float32 map. A request with
"realize": true also gets "pdb" (the realized backbone) and "energy" (its
selection energy) when the server runs with `realize=True` (`--realize`),
else a warning; each design is realized on its own, on the server's device
(`realize/minimize.realize_6d_sample`).

The weights come from the EMA of a training workdir's checkpoint (the
`checkpoint` argument: a slot file such as
`{workdir}/checkpoints/best_eval.pt`, the same without its `.pt` as the
JAX server names it, or the workdir, whose best_eval, best_train or meta
slot is taken in that order), from a torch state-dict file (`--weights
state.pt`, e.g. written from JAX params by `interop.from_jax`) or, without
either, are random from `--seed`.

A thin stdlib HTTP front end serves POST /v1/sample and GET /healthz
({"status", "step", "platform", "batch_size", "max_res_num", "sampler"},
as the JAX server answers; `step` is null without a checkpoint). One
thread owns the device and batches the requests as the JAX server does:
a batch fills until it holds `--batch_size` requests or `--max_wait_ms`
after its first request; a request with a seed runs in a batch of its
own, right after the batch during which it arrived.

Usage (the JAX command line, the module name changed):
  python -m text2protein_tpu_torch.cli.serve [config] [checkpoint]
      [--batch_size 8] [--port 8080] [--sampler pc|ode|hybrid]
      [--num_steps N] [--max_wait_ms 50] [--realize] [--warmup]
      [--weights state.pt] [--seed 0] [--device cpu]
  config and checkpoint may also be given as --config and --checkpoint;
  without a config, the flagship L=128 model. E.g. configs/deploy_l128.yml
  WORKDIR/checkpoints/best_eval --batch_size 16 --realize --warmup: the
  deployment sampler (hybrid ODE head + PC tail, CFG 2.0, NFE 920)
"""

from __future__ import annotations

import base64
import copy
import io
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device, use_full_f32
from ..conditioning import length_mask
from ..config import flagship_config, load_config
from ..diffusion.sampling import get_sampling_fn
from ..diffusion.sde import get_sde
from ..models.unet import build_model, init_random_weights
from ..text.encoder import build_text_encoder
from ..training.checkpoint import restore_ema_params
from . import ArgumentParser


def checkpoint_slot(path):
    """(workdir, slot file or None) of a `checkpoint` argument: a workdir
    (its best_eval, best_train or meta slot, in that order), else the JAX
    server's rule: the workdir is `path.parent.parent` and the slot the
    path itself if it exists (or with `.pt` added, as the JAX package
    names slots without it), else the workdir's first slot in that order."""
    path = Path(path)
    if path.is_dir():
        return path, None
    for slot in (path, path.with_name(path.name + ".pt")):
        if slot.is_file():
            return path.parent.parent, slot
    return path.parent.parent, None


class Server:
    """The model, the sampler and the request batching of one server."""

    def __init__(self, config, batch_size=8, num_steps=None, weights=None,
                 weight_seed=0, device=None, sampler=None, checkpoint=None,
                 realize=False):
        if weights is not None and checkpoint is not None:
            raise ValueError("pass weights or checkpoint, not both")
        if sampler is not None:
            config = copy.deepcopy(config)
            config.sampling.method = sampler
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # every call has the same shapes, so cuDNN's search pays once
            use_full_f32()
        self.config = config
        self.platform = "gpu" if self.device.type == "cuda" else "cpu"
        self.n = config.data.max_res_num
        self.c = config.data.num_channels
        self.b = batch_size
        self.realize = realize
        sde, eps = get_sde(config)
        model = build_model(config, device=self.device)
        self.step = None  # the training step of a checkpoint's weights
        if checkpoint is not None:
            workdir, slot = checkpoint_slot(checkpoint)
            state, self.step = restore_ema_params(workdir, config, model,
                                                  checkpoint=slot)
            model.load_state_dict(state, strict=True)
        elif weights is not None:
            state = torch.load(weights, map_location=self.device,
                               weights_only=True)
            model.load_state_dict(state, strict=True)
        else:
            init_random_weights(model, weight_seed)
        self.model = model.requires_grad_(False)
        self.encoder = build_text_encoder(config)
        self.sampler = get_sampling_fn(
            config, sde, model, (self.b, self.n, self.n, self.c), eps,
            num_steps=num_steps)
        # unseeded requests must not replay the same samples after a restart
        self._counter = int.from_bytes(os.urandom(4), "little")
        self._lock = threading.Lock()

    def _next_seed(self):
        with self._lock:
            self._counter += 1
            return self._counter

    def run_batch(self, reqs):
        """Sample one batch under one seed (the first request's, else a
        fresh one) and return a response per request."""
        if not 1 <= len(reqs) <= self.b:
            raise ValueError(f"a batch holds 1 to {self.b} requests, "
                             f"got {len(reqs)}")
        b, n, dev = self.b, self.n, self.device
        padded = list(reqs) + [reqs[-1]] * (b - len(reqs))
        lengths = torch.tensor([int(r.get("length", n)) for r in padded],
                               device=dev)
        cond = {"length": length_mask(lengths, n)}
        emb, emb_mask = self.encoder.encode(
            [str(r.get("caption", "")) for r in padded])
        seed = int(reqs[0].get("seed", self._next_seed()))
        gen = torch.Generator(device=dev).manual_seed(seed)
        sample, nfe = self.sampler(
            gen, condition=cond,
            context=torch.from_numpy(emb).to(dev),
            context_mask=torch.from_numpy(emb_mask).to(dev),
        )
        sample = sample.cpu().numpy()

        out = []
        for i, r in enumerate(reqs):
            cnn = sample[i].transpose(2, 0, 1)  # reference (C, N, N) layout
            buf = io.BytesIO()
            np.savez_compressed(buf, coords_6d=cnn.astype(np.float32))
            item = {
                "length": int(r.get("length", n)),
                "nfe": int(nfe),
                "seed": seed,
                "coords_6d_b64": base64.b64encode(buf.getvalue()).decode(),
            }
            if r.get("realize") and self.realize:
                item.update(self._realize(cnn, item["length"]))
            elif r.get("realize"):
                item["warning"] = "server started without --realize"
            out.append(item)
        return out

    def _realize(self, cnn, L):
        """The "pdb" and "energy" of one sampled (C, N, N) map, its padding
        channel rebuilt from the requested length first."""
        from ..data.pdbio import format_backbone_pdb
        from ..realize.minimize import realize_6d_sample

        msk = np.zeros((self.n, self.n), np.float32)
        msk[:L, :L] = 1.0
        cnn = cnn.copy()
        cnn[-1] = msk
        bb, energy, _ = realize_6d_sample(cnn, device=self.device)
        return {"pdb": format_backbone_pdb(bb), "energy": float(energy)}


def decode_coords(item) -> np.ndarray:
    """The (C, N, N) map of one response."""
    raw = base64.b64decode(item["coords_6d_b64"])
    with np.load(io.BytesIO(raw)) as z:
        return z["coords_6d"]


class _Worker:
    """One thread owns the device and runs the queued requests a batch at a
    time, by the JAX server's rules (`text2protein_tpu/cli/serve.py`
    `_Server._loop`): a batch starts from the oldest seeded request set
    aside, else from the queue's next; a seeded request at its head runs
    alone, so that its result does not depend on who it shares a batch
    with; otherwise the batch fills until it holds `server.b` requests or
    `max_wait_s` after its first, and a seeded request met while filling
    is set aside for a batch of its own. `start()` starts the thread."""

    def __init__(self, server: Server, max_wait_s=0.05):
        self.server = server
        self.max_wait_s = max_wait_s
        self.q: queue.Queue = queue.Queue()
        self.batches = 0  # batches run
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self.thread.start()
        return self

    def submit(self, req: dict) -> dict:
        slot = {"req": req, "done": threading.Event(), "result": None}
        self.q.put(slot)
        slot["done"].wait()
        return slot["result"]

    def _loop(self):
        pending = []  # seeded requests met while filling a batch
        while True:
            slots = [pending.pop(0) if pending else self.q.get()]
            if "seed" not in slots[0]["req"]:
                deadline = time.monotonic() + self.max_wait_s
                while len(slots) < self.server.b:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self.q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    (pending if "seed" in nxt["req"] else slots).append(nxt)
            try:
                results = self.server.run_batch([s["req"] for s in slots])
            except Exception as e:  # report the failure to every waiter
                results = [{"error": f"{type(e).__name__}: {e}"}] * len(slots)
            self.batches += 1
            for s, r in zip(slots, results):
                s["result"] = r
                s["done"].set()


class _Handler(BaseHTTPRequestHandler):
    worker: _Worker = None  # set on the subclass made in `make_http_server`

    def log_message(self, fmt, *a):
        pass

    def _send(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        s = self.worker.server
        if self.path == "/healthz":
            self._send(200, {
                "status": "ok",
                "step": s.step,
                "platform": s.platform,
                "batch_size": s.b,
                "max_res_num": s.n,
                "sampler": str(s.config.sampling.get("method", "pc")),
            })
        else:
            self._send(404, {"error": "unknown path"})

    def do_POST(self):
        if self.path != "/v1/sample":
            self._send(404, {"error": "unknown path"})
            return
        s = self.worker.server
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            L = int(req.get("length", s.n))
            if not 2 <= L <= s.n:
                raise ValueError(f"length must be in [2, {s.n}]")
        except (ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
            return
        result = self.worker.submit(req)
        self._send(500 if "error" in result else 200, result)


def build_parser():
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.positional_or_flag(
        "config", help="YAML config (default: the flagship L=128 model; "
        "configs/quality_n256.yml: the N=256 model in bf16)")
    p.positional_or_flag(
        "checkpoint", help="a training workdir or one of its checkpoint "
        "slots (checkpoints/best_eval[.pt]): serve its EMA weights")
    p.add_argument("--weights", type=str, default=None,
                   help="torch state dict; default: random weights")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--sampler", type=str, default=None,
                   choices=["pc", "ode", "hybrid"],
                   help="override sampling.method")
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--max_wait_ms", type=int, default=50,
                   help="how long the batcher waits for more requests "
                        "before dispatching a partial batch")
    p.add_argument("--realize", action="store_true",
                   help="allow per-request 3D realization (adds the "
                        "restraint-minimization stage)")
    p.add_argument("--warmup", action="store_true",
                   help="run one dummy batch before serving")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--device", type=str, default=None)
    return p


def make_http_server(server: Server, host="127.0.0.1", port=8080,
                     max_wait_ms=50):
    """The HTTP front end of `server` (port 0 picks a free port), its
    batching thread started."""
    worker = _Worker(server, max_wait_ms / 1000.0).start()
    handler = type("Handler", (_Handler,), {"worker": worker})
    return ThreadingHTTPServer((host, port), handler)


def server_from_args(args) -> Server:
    """The Server the command line asks for."""
    config = load_config(args.config) if args.config else flagship_config()
    return Server(config, batch_size=args.batch_size,
                  num_steps=args.num_steps, weights=args.weights,
                  weight_seed=args.seed, device=args.device,
                  sampler=args.sampler, checkpoint=args.checkpoint,
                  realize=args.realize)


def http_server_from_args(args):
    """The Server and its HTTP front end, bound and announced, not yet
    serving. With `--warmup`, one batch runs first on the batching thread
    (cuDNN keeps its per-shape algorithm choices per thread)."""
    server = server_from_args(args)
    httpd = make_http_server(server, args.host, args.port, args.max_wait_ms)
    if args.warmup:
        t0 = time.time()
        res = httpd.RequestHandlerClass.worker.submit(
            {"length": server.n, "caption": ""})
        if "error" in res:
            raise RuntimeError(f"the warm-up batch failed: {res['error']}")
        print(f"warmup batch done in {time.time() - t0:.1f}s", flush=True)
    weights = (f"step-{server.step} model" if server.step is not None
               else args.weights or f"random weights (seed {args.seed})")
    print(f"serving {weights} on http://{args.host}:"
          f"{httpd.server_address[1]} (platform {server.platform}, device "
          f"{server.device}, batch {server.b})", flush=True)
    return httpd


def main(argv=None):
    """Serve until interrupted (SIGINT), then print the batches run (the
    warm-up included) and the flash kernels' launches, by dtype."""
    from ..ops import flash

    httpd = http_server_from_args(build_parser().parse_args(argv))
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        fwd, bwd = flash.flash_attention_fwd, flash.flash_attention_bwd
        print(f"stopped after {httpd.RequestHandlerClass.worker.batches} "
              f"batches; flash launches: forward {fwd.launches} f32, "
              f"{fwd.launches_bf16} bf16; backward {bwd.launches} f32, "
              f"{bwd.launches_bf16} bf16", flush=True)


if __name__ == "__main__":
    main()
