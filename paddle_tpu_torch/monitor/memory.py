"""paddle_tpu_torch.monitor.memory — device-memory observability and
OOM forensics, the port of `paddle_tpu/monitor/memory.py`.

On the card the allocator is PyTorch's caching allocator, so memory is
read from it rather than hooked:

  * device stats — `torch.cuda.memory_stats(device)` with the JAX
    package's normalized keys on top (`allocated_bytes` =
    `torch.cuda.memory_allocated`, `peak_bytes` =
    `torch.cuda.max_memory_allocated`, `source`), and the device's
    free / total memory (`torch.cuda.mem_get_info`) as `bytes_free` /
    `bytes_limit`. On the CPU, `source` is "census" and the bytes come
    from the live-tensor census. Surfaced as
    `paddle.device.memory_allocated()` / `max_memory_allocated()` /
    `reset_max_memory_allocated()` / `memory_stats()` and the gauges
    `mem/{allocated,peak}_bytes` (synced by `telemetry_snapshot()`).

  * live-tensor census — `live_array_census()` groups every live
    `torch.Tensor` by (shape, dtype, device) and reports bytes + count
    per group, counting each storage once (a view shares its base's
    storage), NEVER tensor contents. The "what is holding the card's
    memory" answer an out-of-memory post-mortem needs.

  * per-program footprints — the port's programs are eager, so there
    is no compiler memory analysis (the JAX package's
    `memory_analysis()`). Its counterpart is the peak-memory delta of
    a program's first call on the card (`first_call_footprint`):
    `max_memory_allocated` over the call minus `memory_allocated`
    before it. On the CPU none is recorded. Gauges land under
    `mem/program/<name>/...` and `jit.cache_report()` carries the same
    numbers into every flight dump bundle (ROADMAP queue 3 records the
    difference).

OOM forensics: `is_oom_error()` classifies `torch.OutOfMemoryError`
and the CUDA "out of memory" message (and the JAX package's
RESOURCE_EXHAUSTED); `oom_observer()` (auto-armed by `hapi.Model.fit`)
writes an "oom" flight bundle whose memory section holds the device
stats, per-program footprints and the top-K census — taken before
unwinding frees the tensors — then clears the traceback's frames so
their tensors go back to the allocator, and re-raises.

Env knobs: PADDLE_MEM_CENSUS_TOP_K (census groups in reports/dumps,
default 15), PADDLE_MEM_PROGRAM (0 disables the first-call footprint),
PADDLE_MEM_STEP (0 disables the per-step StepTimer memory gauges,
which read the card only).
"""
from __future__ import annotations

import contextlib
import gc
import traceback

import torch

from ..core import monitor as _cmon
from .flight import _env_int, _env_on  # shared env-parsing semantics

__all__ = [
    "memory_allocated", "max_memory_allocated",
    "reset_max_memory_allocated", "memory_stats",
    "live_array_census", "sync_gauges", "record_program_memory",
    "first_call_footprint",
    "program_capture_enabled", "step_tracking_enabled",
    "step_reading",
    "program_footprints", "memory_report", "memory_section",
    "is_oom_error", "oom_observer", "auto_oom_observer",
    "census_top_k",
]


def census_top_k():
    """Census groups embedded in reports/dump bundles
    (PADDLE_MEM_CENSUS_TOP_K, default 15; <= 0 means unlimited)."""
    return _env_int("PADDLE_MEM_CENSUS_TOP_K", 15)


def program_capture_enabled():
    """PADDLE_MEM_PROGRAM gate for the first-call footprint (default
    on). Capturing resets the allocator's peak statistic at the start
    of a program's first call."""
    return _env_on("PADDLE_MEM_PROGRAM", True)


def step_tracking_enabled():
    """PADDLE_MEM_STEP gate for the per-step StepTimer memory gauges."""
    return _env_on("PADDLE_MEM_STEP", True)


def step_reading():
    """(allocated, peak) bytes for per-step tracking — one reading of
    the card's allocator; (0, 0) when PADDLE_MEM_STEP=0, without CUDA
    (on the CPU a reading is a census walk over every live object, too
    slow for every step) or when the reading fails (a half-initialized
    card must not break a step)."""
    if not step_tracking_enabled() or not torch.cuda.is_available():
        return 0, 0
    try:
        stats = memory_stats()
        return stats["allocated_bytes"], stats["peak_bytes"]
    except Exception:
        return 0, 0


# ---------------------------------------------------------------------------
# Device stats (the caching allocator; census on the CPU)
# ---------------------------------------------------------------------------

def _resolve_device(device):
    """A torch.device for a reference-API specifier: None (the card
    when CUDA exists, else the CPU), an ordinal, a "gpu:0" / "cuda:0" /
    "cpu" string, or a torch.device."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available()
                            else "cpu")
    if isinstance(device, bool):
        raise TypeError(f"invalid device specifier: {device!r}")
    if isinstance(device, int):
        return torch.device("cuda", device)
    if isinstance(device, str):
        plat, _, idx = device.partition(":")
        if plat.isdigit() and not idx:
            return torch.device("cuda", int(plat))
        if plat == "gpu":
            plat = "cuda"
        return torch.device(f"{plat}:{idx}" if idx else plat)
    return torch.device(device)


def memory_stats(device=None):
    """Full device-memory stat dict: on the card
    `torch.cuda.memory_stats` plus the normalized keys every device
    gets — `allocated_bytes`, `peak_bytes`, `source` ("cuda" |
    "census") — and `bytes_free` / `bytes_limit` from
    `torch.cuda.mem_get_info`. A card this process has not initialized
    reads as empty (this is an evidence path: it never creates a CUDA
    context)."""
    dev = _resolve_device(device)
    if dev.type != "cuda":
        used = live_array_census(top_k=1)["devices"].get(str(dev), 0)
        return {"source": "census", "allocated_bytes": used,
                "peak_bytes": used}
    if not torch.cuda.is_initialized():
        return {"source": "cuda", "allocated_bytes": 0, "peak_bytes": 0}
    out = dict(torch.cuda.memory_stats(dev))
    free, total = torch.cuda.mem_get_info(dev)
    out.update({"source": "cuda",
                "allocated_bytes": int(torch.cuda.memory_allocated(dev)),
                "peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
                "bytes_free": int(free), "bytes_limit": int(total)})
    return out


def memory_allocated(device=None):
    """Bytes currently allocated on the device (reference:
    paddle.device.cuda.memory_allocated): `torch.cuda.memory_allocated`
    on the card, the live-tensor census on the CPU."""
    return memory_stats(device)["allocated_bytes"]


def max_memory_allocated(device=None):
    """High-water mark of allocated bytes since process start or the
    last reset_max_memory_allocated() (reference:
    paddle.device.cuda.max_memory_allocated)."""
    return memory_stats(device)["peak_bytes"]


def reset_max_memory_allocated(device=None):
    """Reset the device's high-water mark to its current allocated
    bytes (`torch.cuda.reset_peak_memory_stats`); returns it."""
    dev = _resolve_device(device)
    if dev.type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats(dev)
    return memory_stats(dev)["peak_bytes"]


def sync_gauges():
    """Push the device memory numbers into the StatRegistry
    (mem/allocated_bytes, mem/peak_bytes) — called by
    monitor.telemetry_snapshot() so exporter flushes, dump bundles and
    /metrics always carry fresh values."""
    stats = memory_stats()
    used, peak = stats["allocated_bytes"], stats["peak_bytes"]
    _cmon.stat_set("mem/allocated_bytes", used)
    _cmon.stat_set("mem/peak_bytes", peak)
    return used, peak


# ---------------------------------------------------------------------------
# Live-tensor census
# ---------------------------------------------------------------------------

def _live_tensors():
    """Every live torch.Tensor the garbage collector tracks, bases
    before views (so a storage is attributed to its base's shape)."""
    out = []
    for obj in gc.get_objects():
        try:
            if issubclass(type(obj), torch.Tensor) \
                    and obj.device.type != "meta":
                out.append(obj)
        except Exception:
            continue  # a half-constructed object
    out.sort(key=lambda t: t._base is not None)
    return out


def _storage_key(t):
    s = t.untyped_storage()
    return (str(t.device), s.data_ptr()), int(s.nbytes())


def live_array_census(top_k=None):
    """Group every live torch.Tensor by (shape, dtype, device): bytes +
    count per group, sorted by bytes descending — never tensor
    CONTENTS. Each storage counts once, in the group of the first
    tensor seen on it (bases come before views), so views add
    nothing. `top_k` caps the group list (None ->
    PADDLE_MEM_CENSUS_TOP_K; <= 0 -> unlimited); the totals (and the
    per-device totals, `devices`) cover every storage."""
    if top_k is None:
        top_k = census_top_k()
    groups = {}
    devices = {}
    seen = set()
    total_bytes = 0
    total_arrays = 0
    for t in _live_tensors():
        try:
            key, nbytes = _storage_key(t)
        except Exception:
            continue
        if not key[1] or key in seen:
            continue
        seen.add(key)
        total_arrays += 1
        total_bytes += nbytes
        devices[key[0]] = devices.get(key[0], 0) + nbytes
        g = (tuple(t.shape), str(t.dtype).replace("torch.", ""), key[0])
        ent = groups.get(g)
        if ent is None:
            groups[g] = [1, nbytes]
        else:
            ent[0] += 1
            ent[1] += nbytes
    ranked = sorted(groups.items(), key=lambda kv: -kv[1][1])
    n_groups = len(ranked)
    if top_k and top_k > 0:
        ranked = ranked[:top_k]
    return {
        "total_bytes": total_bytes,
        "total_arrays": total_arrays,
        "group_count": n_groups,
        "truncated": n_groups > len(ranked),
        "devices": devices,
        "groups": [{"shape": list(shape), "dtype": dtype,
                    "device": dev, "count": cnt, "bytes": nbytes}
                   for (shape, dtype, dev), (cnt, nbytes) in ranked],
    }


# ---------------------------------------------------------------------------
# Per-program footprints (fed by jit at a program's first call)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def first_call_footprint(device):
    """Measure the peak-memory delta of the enclosed call on `device`:
    yields a dict that holds, after the block, {"peak_delta_bytes",
    "total_bytes"} (the same number; total_bytes is the key the JAX
    package's readers rank footprints by) — or stays empty on the CPU
    or when PADDLE_MEM_PROGRAM=0. Resets the allocator's peak
    statistic at entry."""
    out = {}
    dev = torch.device(device)
    if dev.type != "cuda" or not program_capture_enabled():
        yield out
        return
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    yield out
    delta = max(0, int(torch.cuda.max_memory_allocated(dev)) - before)
    out.update({"peak_delta_bytes": delta, "total_bytes": delta})


def record_program_memory(name, *, footprint):
    """The `mem/program/<name>/...` gauge writes for one program's
    first-call footprint; returns it (None when there is none)."""
    if not footprint:
        return None
    for key in ("peak_delta_bytes", "total_bytes"):
        _cmon.stat_set(f"mem/program/{name}/{key}", footprint[key])
    return dict(footprint)


def program_footprints(report=None):
    """Per-program footprints off the live train steps (the same
    numbers jit.cache_report() embeds) — {name: byte dict}. Pass a
    precomputed cache_report() list as `report` to skip the walk (dump
    bundles already hold one for jit_caches)."""
    if report is None:
        try:
            from .. import jit as _jit

            report = _jit.cache_report()
        except Exception:
            return {}
    out = {}
    for ent in report:
        mem = ent.get("memory")
        if not mem:
            continue
        # two live steps can share kind:fn (a fused step and its K=1
        # tail over one model class): suffix instead of overwriting
        name = f"{ent.get('kind')}:{ent.get('fn')}"
        key, n = name, 2
        while key in out:
            key = f"{name}({n})"
            n += 1
        out[key] = mem
    return out


# ---------------------------------------------------------------------------
# Reports / dump-bundle section
# ---------------------------------------------------------------------------

def memory_report(top_k=None):
    """The full live picture: device stats + per-program footprints +
    the live-tensor census (what /memz serves and an OOM bundle
    embeds)."""
    return {"device": memory_stats(),
            "programs": program_footprints(),
            "census": live_array_census(top_k)}


def memory_section(census=True, jit_report=None):
    """The `memory` key of a flight dump bundle. The census is included
    for OOM / live-inspection dumps; watchdog / crash bundles keep the
    cheap device + program half unless asked."""
    try:
        out = {"device": memory_stats(),
               "programs": program_footprints(jit_report)}
        if census:
            out["census"] = live_array_census()
        return out
    except Exception as e:  # forensics must never break the dump
        return {"error": f"{type(e).__name__}: {e}"}


# ---------------------------------------------------------------------------
# OOM classification + observer
# ---------------------------------------------------------------------------

def is_oom_error(exc):
    """True for an out-of-memory: `torch.OutOfMemoryError` (what the
    caching allocator raises, and what the chaos `resource_exhausted`
    fault raises), a RuntimeError carrying CUDA's "out of memory"
    message, or the JAX package's XlaRuntimeError RESOURCE_EXHAUSTED."""
    if exc is None:
        return False
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    msg = str(exc)
    if type(exc).__name__ in ("XlaRuntimeError", "JaxRuntimeError"):
        return "RESOURCE_EXHAUSTED" in msg or "Out of memory" in msg
    return isinstance(exc, RuntimeError) and "CUDA out of memory" in msg


@contextlib.contextmanager
def oom_observer(reason="oom"):
    """Context manager that turns an out-of-memory into a forensics
    bundle WITH the memory section (device stats, per-program
    footprints, top-K live-tensor census — taken here, while the
    tensors of the failed call are still referenced by the traceback's
    frames), then clears those frames so the tensors go back to the
    allocator, and re-raises. Auto-armed around the `hapi.Model.fit`
    train loop; the flight excepthook skips re-dumping an exception
    this observer already bundled."""
    try:
        yield
    except Exception as e:
        if is_oom_error(e) and not getattr(
                e, "_paddle_flight_dumped", False):
            try:
                from . import flight as _flight
                import sys

                _flight.record("oom", message=str(e)[:300])
                _flight.write_dump(
                    reason, full_memory=True,
                    extra={"exception": _flight._format_exception(
                        *sys.exc_info())})
                try:
                    e._paddle_flight_dumped = True
                except Exception:
                    pass
            except Exception:
                pass  # forensics must not mask the original OOM
            # the census is on disk: let the failed call's locals go
            traceback.clear_frames(e.__traceback__)
        raise


def auto_oom_observer():
    """What `hapi.Model.fit` wraps the train loop in: oom_observer()
    unless PADDLE_FLIGHT_AUTOARM is set falsy (the off switch
    flight.maybe_auto_arm honors). Explicit oom_observer() calls are
    never gated."""
    if _env_on("PADDLE_FLIGHT_AUTOARM", True):
        return oom_observer()
    return contextlib.nullcontext()
