"""The port's request batcher (`cli/serve._Worker`) held to the JAX
server's (`text2protein_tpu/cli/serve._Server._loop`): the same request
sequences, put into both, form the same batches.

The JAX batcher runs on an instance made with `object.__new__` (no model,
no device), its `_run_batch` a recorder; the port's runs on a recording
stand-in server. Both loops are daemon threads, and every wait has a
time limit, so a fault fails the test instead of hanging the suite.
"""

import queue
import threading

import pytest

from text2protein_tpu.cli.serve import _Server as JServer
from text2protein_tpu_torch.cli.serve import _Worker, make_http_server

WAIT_S = 60   # the limit of every wait
WINDOW_S = 1.0  # a window long enough that queued requests always join


class _Queue(queue.Queue):
    """A queue that counts the items taken from it, under a condition."""

    def __init__(self):
        super().__init__()
        self.taken = 0
        self.took = threading.Condition()

    def get(self, *a, **kw):
        item = super().get(*a, **kw)
        with self.took:
            self.taken += 1
            self.took.notify_all()
        return item

    def wait_taken(self, n):
        with self.took:
            assert self.took.wait_for(lambda: self.taken >= n, WAIT_S)


class _Recorder:
    """The stand-in server: records each batch as its requests' ids."""

    def __init__(self, b):
        self.b = b
        self.batches = []
        self.ran = threading.Condition()

    def run_batch(self, reqs):
        with self.ran:
            self.batches.append([r["id"] for r in reqs])
            self.ran.notify_all()
        return [{"id": r["id"]} for r in reqs]

    def wait_batches(self, n):
        with self.ran:
            assert self.ran.wait_for(lambda: len(self.batches) >= n, WAIT_S)


def _jax(rec, max_wait_s):
    """(queue, thread) of JAX's batcher."""
    server = object.__new__(JServer)
    server.q = _Queue()
    server.b = rec.b
    server.max_wait_s = max_wait_s
    server._run_batch = rec.run_batch
    return server.q, threading.Thread(target=server._loop, daemon=True)


def _port(rec, max_wait_s):
    """(queue, thread) of the port's batcher."""
    worker = _Worker(rec, max_wait_s)
    worker.q = _Queue()
    return worker.q, worker.thread


def _req(name):
    """A request: "s..." carries a seed, "u..." does not."""
    req = {"id": name}
    if name.startswith("s"):
        req["seed"] = int(name[1:])
    return req


def _slot(name):
    return {"req": _req(name), "done": threading.Event(), "result": None}


def _finish(slots):
    for s in slots:
        assert s["done"].wait(WAIT_S), s["req"]
        assert s["result"] == {"id": s["req"]["id"]}


def _prefilled(make, names, b, max_wait_s=WINDOW_S):
    """The batches formed from a queue that holds `names` before the loop
    starts."""
    rec = _Recorder(b)
    q, thread = make(rec, max_wait_s)
    slots = [_slot(n) for n in names]
    for s in slots:
        q.put(s)
    thread.start()
    _finish(slots)
    return rec.batches


PREFILLED = {
    # a seeded request met while filling waits for the batch, then runs
    # alone; the port used to run it after u5
    "seeded_in_a_burst": (4, ["u1", "s1", "u2", "u3", "u4", "u5"],
                          [["u1", "u2", "u3", "u4"], ["s1"], ["u5"]]),
    "seeded_at_the_head": (4, ["s1", "u1", "u2"],
                           [["s1"], ["u1", "u2"]]),
    "two_seeded_in_a_row": (4, ["u1", "s1", "s2", "u2"],
                            [["u1", "u2"], ["s1"], ["s2"]]),
    "two_seeded_at_the_head": (4, ["s1", "s2", "u1"],
                               [["s1"], ["s2"], ["u1"]]),
    "longer_than_the_batch": (4, [f"u{i}" for i in range(1, 10)],
                              [["u1", "u2", "u3", "u4"],
                               ["u5", "u6", "u7", "u8"], ["u9"]]),
    "set_aside_then_queued_seeded": (
        4, ["u1", "s1", "u2", "s2", "u3", "u4", "s3", "u5", "u6"],
        [["u1", "u2", "u3", "u4"], ["s1"], ["s2"], ["s3"], ["u5", "u6"]]),
    "batch_of_one": (1, ["u1", "s1", "u2"], [["u1"], ["s1"], ["u2"]]),
}


@pytest.mark.parametrize("case", list(PREFILLED))
def test_prefilled_queue_forms_the_jax_batches(case):
    b, names, want = PREFILLED[case]
    got_jax = _prefilled(_jax, names, b)
    got_port = _prefilled(_port, names, b)
    assert got_jax == want
    assert got_port == got_jax


def _straggler(make, max_wait_s, seeded_first=False):
    """u1 starts a batch; once the loop has taken it, u9 arrives (after
    s5 with `seeded_first`)."""
    rec = _Recorder(4)
    q, thread = make(rec, max_wait_s)
    first = _slot("u1")
    q.put(first)
    thread.start()
    q.wait_taken(1)
    later = [_slot(n) for n in (["s5"] if seeded_first else []) + ["u9"]]
    for s in later:
        q.put(s)
    _finish([first, *later])
    return rec.batches


@pytest.mark.parametrize("seeded_first", [False, True])
def test_straggler_inside_the_window_joins_the_batch(seeded_first):
    """A request that arrives while the batch waits joins it (the port used
    to run two trajectories); a seeded one arriving then runs next, alone."""
    want = [["u1", "u9"]] + ([["s5"]] if seeded_first else [])
    assert _straggler(_jax, WINDOW_S, seeded_first) == want
    assert _straggler(_port, WINDOW_S, seeded_first) == want


def test_straggler_after_the_batch_left_runs_in_the_next():
    def run(make):
        rec = _Recorder(4)
        q, thread = make(rec, 0.05)
        first = _slot("u1")
        q.put(first)
        thread.start()
        rec.wait_batches(1)
        second = _slot("u9")
        q.put(second)
        _finish([first, second])
        return rec.batches

    assert run(_jax) == run(_port) == [["u1"], ["u9"]]


def test_zero_window_takes_one_request_a_batch():
    """With --max_wait_ms 0 both loops dispatch each request alone, queued
    or not (the deadline has passed before the first fill)."""
    names = ["u1", "u2", "u3"]
    assert (_prefilled(_jax, names, 4, 0.0)
            == _prefilled(_port, names, 4, 0.0)
            == [["u1"], ["u2"], ["u3"]])


def test_a_failed_batch_reports_to_every_waiter():
    class Failing(_Recorder):
        def run_batch(self, reqs):
            super().run_batch(reqs)
            raise RuntimeError("out of memory")

    rec = Failing(4)
    q, thread = _port(rec, WINDOW_S)
    slots = [_slot(n) for n in ("u1", "u2")]
    for s in slots:
        q.put(s)
    thread.start()
    for s in slots:
        assert s["done"].wait(WAIT_S)
        assert s["result"] == {"error": "RuntimeError: out of memory"}
    assert rec.batches == [["u1", "u2"]]


def test_make_http_server_passes_the_window_to_the_batcher():
    rec = _Recorder(2)
    httpd = make_http_server(rec, port=0, max_wait_ms=250)
    try:
        worker = httpd.RequestHandlerClass.worker
        assert worker.max_wait_s == 0.25 and worker.thread.is_alive()
    finally:
        httpd.server_close()
