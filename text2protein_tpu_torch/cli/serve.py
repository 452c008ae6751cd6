"""Sampling server (counterpart of text2protein_tpu/cli/serve.py).

`Server` owns the model and the PC sampler at a fixed batch size; each call
of `run_batch(requests)` encodes the captions, builds the length masks, runs
one trajectory for the batch (padded with copies of the last request) and
returns one response per request, with the same fields as the JAX server:
{"length", "nfe", "seed", "coords_6d_b64"} where `coords_6d_b64` is a base64
npz holding "coords_6d", the (C, N, N) float32 map.

The weights come from a torch state-dict file (`--weights state.pt`, e.g.
written from JAX params by `interop.from_jax`) or, without one, are random
from `--seed`. A thin stdlib HTTP front end serves POST /v1/sample and
GET /healthz.

Usage:
  python -m text2protein_tpu_torch.cli.serve [--config cfg.yml]
      [--weights state.pt] [--batch_size 8] [--num_steps 100] [--port 8080]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .. import resolve_device
from ..conditioning import length_mask
from ..config import flagship_config, load_config
from ..diffusion.sampling import get_sampling_fn
from ..diffusion.sde import get_sde
from ..models.unet import build_model, init_random_weights
from ..text.encoder import build_text_encoder


class Server:
    """The model, the sampler and the request batching of one server."""

    def __init__(self, config, batch_size=8, num_steps=None, weights=None,
                 weight_seed=0, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # Every call has the same shapes, so cuDNN's per-shape search
            # pays once. Without it, cuDNN's heuristic takes an FFT
            # algorithm for some f32 convolutions of this UNet that launches
            # ~200k small kernels per PC step (70x slower on an H100).
            # This is a process-wide setting.
            torch.backends.cudnn.benchmark = True
        self.n = config.data.max_res_num
        self.c = config.data.num_channels
        self.b = batch_size
        sde, eps = get_sde(config)
        model = build_model(config, device=self.device)
        if weights is not None:
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
            if r.get("realize"):
                item["warning"] = "3D realization is not ported yet"
            out.append(item)
        return out


def decode_coords(item) -> np.ndarray:
    """The (C, N, N) map of one response."""
    raw = base64.b64decode(item["coords_6d_b64"])
    with np.load(io.BytesIO(raw)) as z:
        return z["coords_6d"]


class _Worker:
    """One thread owns the device and runs the queued requests one batch at
    a time; a request with a seed runs in a batch of its own, so that its
    result does not depend on who it shares a batch with."""

    def __init__(self, server: Server):
        self.server = server
        self.q: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, req: dict) -> dict:
        slot = {"req": req, "done": threading.Event(), "result": None}
        self.q.put(slot)
        slot["done"].wait()
        return slot["result"]

    def _loop(self):
        while True:
            slots = [self.q.get()]
            if "seed" not in slots[0]["req"]:
                while len(slots) < self.server.b:
                    try:
                        nxt = self.q.get_nowait()
                    except queue.Empty:
                        break
                    if "seed" in nxt["req"]:
                        self.q.put(nxt)  # runs in a later batch of its own
                        break
                    slots.append(nxt)
            try:
                results = self.server.run_batch([s["req"] for s in slots])
            except Exception as e:  # report the failure to every waiter
                results = [{"error": f"{type(e).__name__}: {e}"}] * len(slots)
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
            self._send(200, {"status": "ok", "device": str(s.device),
                             "batch_size": s.b, "max_res_num": s.n})
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
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", type=str, default=None,
                   help="YAML config (default: the flagship L=128 model)")
    p.add_argument("--weights", type=str, default=None,
                   help="torch state dict; default: random weights")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--device", type=str, default=None)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    return p


def make_http_server(server: Server, host="127.0.0.1", port=8080):
    """The HTTP front end of `server` (port 0 picks a free port)."""
    handler = type("Handler", (_Handler,), {"worker": _Worker(server)})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    args = build_parser().parse_args(argv)
    config = load_config(args.config) if args.config else flagship_config()
    server = Server(config, batch_size=args.batch_size,
                    num_steps=args.num_steps, weights=args.weights,
                    weight_seed=args.seed, device=args.device)
    httpd = make_http_server(server, args.host, args.port)
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"({server.device}, batch {server.b})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
