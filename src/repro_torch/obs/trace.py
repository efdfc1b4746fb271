"""Span tracing: lightweight context-manager spans exported as Chrome
trace-event JSON (loadable in Perfetto / chrome://tracing).

The observability layer's second pillar, the port of the JAX package's
`repro.obs.trace`. A `Tracer` collects complete ("ph": "X") trace events;
`span("engine.step", step=7)` times a block and records one event with
its keyword arguments as event args, so the prefill / decode / scrub /
preemption interleaving of the serving engine becomes a timeline per step
and per tenant.

    tracer = Tracer()
    with use_tracer(tracer):
        engine.run()
    tracer.to_chrome_trace("trace.json")       # open in ui.perfetto.dev

Disabled (the default), `span(...)` returns a shared no-op context
manager: the hot loop pays one ambient lookup and nothing else.

Two torch-aware extras:

- `span(..., sync=t)` waits for the tensor `t` (or a list, tuple or dict
  of tensors) before the span closes: `torch.cuda.synchronize` on each
  CUDA device among them, nothing for CPU tensors. Without `sync=` a span
  never waits, so a traced program launches and synchronizes exactly as
  the untraced one does (the recorded duration is then the host's, and
  device work queued in a span may be billed to a later one that waits);
- `Tracer(torch_profiler=True)` also enters
  `torch.profiler.record_function(name)` for every span, so the same span
  names appear in a `torch.profiler` capture.

Nesting is tracked per thread: sibling and child spans nest in the
rendered flame because their timestamps nest; `depth` rides in the event
args for programmatic consumers.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time

__all__ = ["Tracer", "NULL_TRACER", "current", "use_tracer", "span"]


class _Span:
    """One in-flight span (context manager recorded on exit)."""

    __slots__ = ("tracer", "name", "args", "sync", "t0", "depth")

    def __init__(self, tracer: "Tracer", name: str, sync, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.sync = sync
        self.t0 = 0
        self.depth = 0

    def __enter__(self):
        tl = self.tracer._tls
        self.depth = getattr(tl, "depth", 0)
        tl.depth = self.depth + 1
        self.tracer._enter_profiler(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.sync is not None:
            _wait(self.sync)
        t1 = time.perf_counter_ns()
        self.tracer._exit_profiler()
        self.tracer._tls.depth = self.depth
        self.tracer._record(self.name, self.t0, t1, self.depth, self.args)
        return False

    def set(self, **args) -> None:
        """Attach/overwrite event args from inside the span."""
        self.args.update(args)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _NullTracer:
    enabled = False

    def span(self, name: str, *, sync=None, **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, **args) -> None:
        pass

    def events(self) -> list:
        return []


NULL_TRACER = _NullTracer()


class Tracer:
    """Collects Chrome trace events. `max_events` bounds memory (oldest
    events are dropped with a `truncated` marker rather than growing
    without bound under a long-running engine)."""

    enabled = True

    def __init__(self, *, pid: int = 0, max_events: int = 200_000,
                 torch_profiler: bool = False):
        self.pid = pid
        self.max_events = max_events
        self.torch_profiler = torch_profiler
        self._events: list[dict] = []
        self._dropped = 0
        self._epoch_ns = time.perf_counter_ns()
        self._tls = threading.local()
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------------

    def span(self, name: str, *, sync=None, **args) -> _Span:
        """Context manager timing a block; `sync` (a tensor, or a list,
        tuple or dict of them) is waited for before the span closes, so
        its device work is billed to the span that launched it."""
        return _Span(self, name, sync, args)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event (preemptions, injections)."""
        ts = (time.perf_counter_ns() - self._epoch_ns) / 1e3
        self._append({"name": name, "ph": "i", "s": "t", "ts": ts,
                      "pid": self.pid, "tid": threading.get_ident() % 2**31,
                      "args": args})

    def _record(self, name, t0_ns, t1_ns, depth, args) -> None:
        ev_args = dict(args)
        ev_args["depth"] = depth
        self._append({
            "name": name, "ph": "X",
            "ts": (t0_ns - self._epoch_ns) / 1e3,        # microseconds
            "dur": (t1_ns - t0_ns) / 1e3,
            "pid": self.pid, "tid": threading.get_ident() % 2**31,
            "args": ev_args})

    def _append(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self._events.pop(0)
                self._dropped += 1
            self._events.append(ev)

    def _enter_profiler(self, name: str) -> None:
        if not self.torch_profiler:
            return
        import torch
        rec = torch.profiler.record_function(name)
        rec.__enter__()
        stack = getattr(self._tls, "annotations", None)
        if stack is None:
            stack = self._tls.annotations = []
        stack.append(rec)

    def _exit_profiler(self) -> None:
        if not self.torch_profiler:
            return
        stack = getattr(self._tls, "annotations", None)
        if stack:
            stack.pop().__exit__(None, None, None)

    # -- export --------------------------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def spans(self, name: str | None = None) -> list[dict]:
        """Complete ("X") events, optionally filtered by name."""
        return [e for e in self.events()
                if e["ph"] == "X" and (name is None or e["name"] == name)]

    def to_chrome_trace(self, path: str | None = None) -> dict:
        """The Chrome trace-event JSON object; written to `path` when
        given. Load with chrome://tracing or ui.perfetto.dev."""
        doc = {"traceEvents": self.events(), "displayTimeUnit": "ms",
               "otherData": {"dropped_events": self._dropped}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


def _wait(sync) -> None:
    """Wait for the device work behind `sync`: one synchronize per CUDA
    device among its tensors (CPU tensors are already done)."""
    import torch
    todo, devices = [sync], set()
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# ambient tracer
# ---------------------------------------------------------------------------

_current = NULL_TRACER


def current():
    return _current


@contextlib.contextmanager
def use_tracer(tracer: Tracer | None = None):
    """Install `tracer` as the ambient span sink for the block (a fresh
    `Tracer` when called with None). Yields the tracer."""
    global _current
    tr = Tracer() if tracer is None else tracer
    prev = _current
    _current = tr
    try:
        yield tr
    finally:
        _current = prev


def span(name: str, *, sync=None, **args):
    """`with span("engine.step", step=i):` — records on the ambient tracer,
    free (a shared no-op) when tracing is disabled."""
    t = _current
    if not t.enabled:
        return _NULL_SPAN
    return t.span(name, sync=sync, **args)
