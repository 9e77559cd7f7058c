"""paddle_tpu_torch.monitor.perf — compute/roofline observability, the
port of `paddle_tpu/monitor/perf.py` (:103-365).

  * per-program cost ledger — `record_program_cost()` writes each
    program's flops / bytes accessed under `perf/program/<name>/...`,
    and `jit.cache_report()` carries the same numbers ("cost") into
    every flight dump bundle. The JAX package reads them from XLA's
    `cost_analysis()`. The port has no compiler, and its train step
    records no cost: counting its aten ops takes a dispatch mode, whose
    first use imports `torch._dynamo` (seconds, once a process), and a
    ctypes kernel launch is invisible to it (ROADMAP queue 3). A
    caller with its own count records it here.

  * measured attribution — the dispatch sites observe each program's
    wall time, blocked on its outputs (a device synchronisation on the
    card), into `jit/hist/<name>/dispatch_us`; `perf_report()` combines
    ledger and measurement into achieved FLOP/s, arithmetic intensity
    and MFU against the device-kind peak table, with a roofline
    verdict per program. StepTimer's `step/attrib/*` decomposition
    reads the flight ring's spans.

Env knobs: PADDLE_PERF_PROGRAM (0 disables the cost ledger),
PADDLE_PERF_DISPATCH (0 disables the dispatch histograms; on by
default as in the JAX package — each observation synchronises the
device), PADDLE_PERF_STEP (0 disables the StepTimer decomposition),
PADDLE_PEAK_TFLOPS / PADDLE_HBM_GBPS / PADDLE_ICI_GBPS (peak-table
overrides).
"""
from __future__ import annotations

from ..core import monitor as _cmon
from ..core.monitor import snapshot_quantile
from .flight import _env_float, _env_on  # shared env-parsing semantics

__all__ = [
    "program_capture_enabled", "dispatch_timing_enabled",
    "step_attrib_enabled", "record_program_cost", "observe_dispatch",
    "program_costs", "device_peaks", "roofline_verdict", "perf_report",
    "PEAK_TABLE",
]


def program_capture_enabled():
    """PADDLE_PERF_PROGRAM gate for the cost ledger (default on; the
    count runs once per program, over its first call)."""
    return _env_on("PADDLE_PERF_PROGRAM", True)


def dispatch_timing_enabled():
    """PADDLE_PERF_DISPATCH gate for per-program dispatch wall-time
    histograms. Each observation blocks on the dispatch's outputs (a
    device synchronisation), which serializes the host/device overlap;
    0 restores fully async dispatch."""
    return _env_on("PADDLE_PERF_DISPATCH", True)


def step_attrib_enabled():
    """PADDLE_PERF_STEP gate for StepTimer's per-step
    `step/attrib/*` decomposition (a flight-ring tail walk per
    step)."""
    return _env_on("PADDLE_PERF_STEP", True)


# ---------------------------------------------------------------------------
# Per-program cost ledger
# ---------------------------------------------------------------------------

_COST_FIELDS = ("flops", "bytes_accessed", "transcendentals")


def record_program_cost(name, *, cost):
    """The `perf/program/<name>/...` gauge writes for one program's
    cost dict ({"flops", "bytes_accessed", "transcendentals"});
    returns the dict (cache_report's "cost" field), or None when there
    is none or capture is disabled."""
    if not program_capture_enabled() or not cost:
        return None
    out = {k: max(0, int(cost.get(k, 0) or 0)) for k in _COST_FIELDS}
    for key in _COST_FIELDS:
        _cmon.stat_set(f"perf/program/{name}/{key}", out[key])
    return out


def observe_dispatch(name, dur_us):
    """One blocked-on-ready dispatch wall-time observation for
    program `name` — the measured leg the roofline divides the
    ledger's FLOPs by."""
    _cmon.hist_observe(f"jit/hist/{name}/dispatch_us", dur_us)


def program_costs(report=None):
    """Per-program costs off the live train steps (the same numbers
    jit.cache_report() embeds as "cost") — {name: cost dict}. Pass a
    precomputed cache_report() list as `report` to skip the walk (dump
    bundles hold one as jit_caches). The naming mirrors
    memory.program_footprints: kind:fn, "(n)" suffixes for sibling
    steps sharing kind:fn."""
    if report is None:
        try:
            from .. import jit as _jit

            report = _jit.cache_report()
        except Exception:
            return {}
    out = {}

    def _put(name, c):
        key, n = name, 2
        while key in out:
            key = f"{name}({n})"
            n += 1
        out[key] = c

    for ent in report:
        cost = ent.get("cost")
        if cost:
            _put(f"{ent.get('kind')}:{ent.get('fn')}", cost)
    return out


# ---------------------------------------------------------------------------
# Device-kind peak table + roofline math
# ---------------------------------------------------------------------------

# kind tag -> (peak dense-bf16 TFLOP/s per device, HBM GB/s, per-device
# interconnect GB/s). h100: the H100 SXM5 data sheet's figures — 989
# TFLOP/s dense BF16 tensor core, 3,350 GB/s HBM3, NVLink 4 at 900
# GB/s bidirectional = 450 GB/s per direction. The cpu row is the JAX
# package's deliberately modest stand-in, so CPU runs still get finite
# MFU / verdicts (override via env for a specific host).
PEAK_TABLE = {
    "h100": (989.0, 3350.0, 450.0),
    "cpu": (0.2, 50.0, 10.0),
}

# device-name substrings -> table tag, checked in order
_KIND_TAGS = (
    (("h100",), "h100"),
)


def device_peaks():
    """The roofline ceilings for THIS process's card:
    {"device_kind", "matched", "peak_tflops", "hbm_gbps",
    "ici_gbps"}. device_kind is torch.cuda.get_device_name (read only
    once CUDA is initialized: this is an evidence path); unknown kinds
    and the CPU fall back to the cpu row. PADDLE_PEAK_TFLOPS /
    PADDLE_HBM_GBPS / PADDLE_ICI_GBPS override individual legs."""
    kind = "cpu"
    try:
        from .flight import _cuda_live

        if _cuda_live():
            import torch

            kind = str(torch.cuda.get_device_name(
                torch.cuda.current_device()))
    except Exception:
        pass
    low = kind.lower()
    matched = "cpu"
    for subs, tag in _KIND_TAGS:
        if any(s in low for s in subs):
            matched = tag
            break
    tf, hbm, ici = PEAK_TABLE[matched]
    return {
        "device_kind": kind,
        "matched": matched,
        "peak_tflops": _env_float("PADDLE_PEAK_TFLOPS", tf),
        "hbm_gbps": _env_float("PADDLE_HBM_GBPS", hbm),
        "ici_gbps": _env_float("PADDLE_ICI_GBPS", ici),
    }


def roofline_verdict(flops, bytes_accessed, peak_tflops, hbm_gbps,
                     comm_frac=0.0):
    """Classify one program against the roofline: "comm-bound" when
    the interconnect leg dominates the measured time (comm_frac >
    0.5), else compare arithmetic intensity (flops/byte) with the
    machine balance (peak_flops / hbm_bandwidth): below balance the
    HBM leg caps the program, at/above it the tensor cores do."""
    if comm_frac > 0.5:
        return "comm-bound"
    if not flops or not bytes_accessed:
        return "unknown"
    intensity = flops / float(bytes_accessed)
    balance = (peak_tflops * 1e12) / (hbm_gbps * 1e9)
    return "compute-bound" if intensity >= balance else "HBM-bound"


# ---------------------------------------------------------------------------
# The roofline report (/perfz)
# ---------------------------------------------------------------------------

def _parse_program_gauges(stats):
    """{name: {flops, bytes_accessed, transcendentals}} out of the
    flat perf/program/<name>/<key> gauge namespace."""
    progs = {}
    prefix = "perf/program/"
    for k, v in (stats or {}).items():
        if not k.startswith(prefix):
            continue
        rest = k[len(prefix):]
        name, _, key = rest.rpartition("/")
        if name and key:
            progs.setdefault(name, {})[key] = v
    return progs


def _dispatch_snap(hists, name):
    """The program's dispatch histogram snapshot — shape-specialized
    `#N` ledger entries share their base name's histogram (one
    distribution per fn, like jit/<fn>/compile_us)."""
    snap = (hists or {}).get(f"jit/hist/{name}/dispatch_us")
    if snap is None and "#" in name:
        snap = (hists or {}).get(
            f"jit/hist/{name.split('#')[0]}/dispatch_us")
    return snap


def perf_report(stats=None, hists=None, peaks=None):
    """The full compute-attribution picture: the peak ceilings, the
    comm leg (wire bytes priced against the interconnect), and per
    program the cost ledger + measured dispatch quantiles + achieved
    FLOP/s, arithmetic intensity, MFU and roofline verdict. Reads
    the LIVE registries by default; pass a dump bundle's
    telemetry["stats"]/["hists"] for offline forensics."""
    if stats is None:
        stats = _cmon.registry.snapshot()
    if hists is None:
        hists = _cmon.registry.snapshot_histograms()
    if peaks is None:
        peaks = device_peaks()
    progs = _parse_program_gauges(stats)
    # total measured dispatch seconds across every program — the
    # denominator the comm leg is weighed against
    total_s = 0.0
    seen_hists = set()
    for name in progs:
        snap = _dispatch_snap(hists, name)
        if snap is not None and id(snap) not in seen_hists:
            seen_hists.add(id(snap))
            total_s += float(snap.get("sum", 0.0)) / 1e6
    wire = sum(v for k, v in (stats or {}).items()
               if k.startswith("comm/") and k.endswith("/wire_bytes"))
    comm_s = wire / (peaks["ici_gbps"] * 1e9) \
        if peaks["ici_gbps"] > 0 else 0.0
    comm_frac = comm_s / total_s if total_s > 0 else 0.0
    out_progs = {}
    for name in sorted(progs):
        cost = progs[name]
        flops = int(cost.get("flops", 0))
        ba = int(cost.get("bytes_accessed", 0))
        ent = {"flops": flops, "bytes_accessed": ba,
               "transcendentals": int(cost.get("transcendentals", 0)),
               "dispatch": None, "achieved_gflops": None,
               "intensity": None, "mfu": None,
               "verdict": roofline_verdict(
                   flops, ba, peaks["peak_tflops"],
                   peaks["hbm_gbps"], comm_frac)}
        if flops and ba:
            ent["intensity"] = round(flops / float(ba), 3)
        snap = _dispatch_snap(hists, name)
        if snap is not None and snap.get("count"):
            p50 = snapshot_quantile(snap, 0.5)
            ent["dispatch"] = {
                "count": int(snap["count"]),
                "p50_us": round(p50, 1),
                "p99_us": round(snapshot_quantile(snap, 0.99), 1),
            }
            if flops and p50 > 0:
                ach = flops / (p50 / 1e6)
                ent["achieved_gflops"] = round(ach / 1e9, 3)
                ent["mfu"] = round(
                    ach / (peaks["peak_tflops"] * 1e12), 4)
        out_progs[name] = ent
    return {
        "peaks": peaks,
        "comm": {"wire_bytes": int(wire),
                 "est_us": int(comm_s * 1e6),
                 "frac": round(comm_frac, 4)},
        "measured_total_us": int(total_s * 1e6),
        "programs": out_progs,
    }
