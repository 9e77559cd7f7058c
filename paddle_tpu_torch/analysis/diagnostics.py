"""Diagnostic findings: the part of `paddle_tpu/analysis/diagnostics.py`
(:220-330) that the runtime sanitizer and `amp` report through --
`Severity`, `Finding`, `Report` -- and the `DIAGNOSTICS` rows of the
codes the port raises at run time (PTA043, PTA060/061/063,
PTA070/071/074, PTA092/093), each as the JAX package states it. The
static analysis passes and their codes are not ported (ROADMAP queue 1
item 4, "Waits").
"""
from __future__ import annotations

__all__ = ["Severity", "Finding", "Report", "DIAGNOSTICS",
           "severity_rank"]


class Severity:
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"


_SEV_RANK = {Severity.ERROR: 2, Severity.WARNING: 1, Severity.INFO: 0}


def severity_rank(sev):
    return _SEV_RANK.get(sev, 0)


# code -> (default severity, title, typical fix)
DIAGNOSTICS = {
    "PTA043": (Severity.ERROR,
               "host snapshot does not own its memory (zero-copy "
               "view of a live device buffer)",
               "np.array(...) (owned copy), never np.asarray, before "
               "the next donating dispatch"),
    "PTA060": (Severity.ERROR,
               "potential deadlock: lock-acquisition-order cycle",
               "impose one global lock order or drop the inner lock "
               "before blocking"),
    "PTA061": (Severity.WARNING,
               "lock held across blocking work (timed hold over "
               "threshold)",
               "move IO/joins/sleeps outside the critical section"),
    "PTA063": (Severity.WARNING,
               "non-daemon thread still alive at exit/close",
               "join worker threads in close(); daemonize pure "
               "observers"),
    "PTA070": (Severity.ERROR,
               "KV block leak: pool blocks not freed on request "
               "completion/eviction (or an alloc whose result is "
               "discarded)",
               "release(owner) on every terminal request path; "
               "keep the block ids alloc() returns"),
    "PTA071": (Severity.ERROR,
               "KV block double-free or free of an unowned block",
               "free blocks exactly once, through the owner that "
               "holds them"),
    "PTA074": (Severity.ERROR,
               "prefix-cache refcount/COW violation: a shared KV "
               "block written in place (copy-on-write skipped), "
               "physically reclaimed while another owner still maps "
               "it, or allocator internals (._free/._refcnt) reached "
               "from outside the allocator",
               "check_cow() before every in-place block write; "
               "release references through share()/release() only "
               "and keep refcount bookkeeping inside BlockAllocator"),
    "PTA092": (Severity.ERROR,
               "exp/log/softmax/norm statistics computed in float16 "
               "(e^x saturates past x~11; fp16 max 65504) — or, at "
               "runtime, a probed tensor saturating/going non-finite",
               "compute range statistics in float32 (or bfloat16) "
               "and cast after"),
    "PTA093": (Severity.ERROR,
               "float16 master-weightless training: fp16 trainable "
               "params stepped without a GradScaler or fp32 master "
               "weights",
               "pass grad_scaler=GradScaler() to the train step or "
               "enable optimizer multi_precision"),
}


class Finding:
    """One diagnostic: code + severity + message + file:line anchor."""

    __slots__ = ("code", "severity", "message", "file", "line",
                 "analyzer")

    def __init__(self, code, message, file=None, line=None,
                 severity=None, analyzer=""):
        self.code = code
        self.severity = severity or DIAGNOSTICS.get(
            code, (Severity.WARNING,))[0]
        self.message = message
        self.file = file
        self.line = line
        self.analyzer = analyzer

    @property
    def anchor(self):
        if self.file:
            return (f"{self.file}:{self.line}" if self.line
                    else str(self.file))
        return "<unknown>"

    def format(self):
        return (f"{self.anchor}: {self.code} {self.severity}: "
                f"{self.message}")

    def to_dict(self):
        return {"code": self.code, "severity": self.severity,
                "message": self.message, "file": self.file,
                "line": self.line, "analyzer": self.analyzer}

    def __repr__(self):
        return f"<Finding {self.format()}>"


class Report:
    """Ordered finding collection + the CLI/monitor contract."""

    def __init__(self):
        self.findings = []

    def add(self, code, message, file=None, line=None, severity=None,
            analyzer=""):
        f = Finding(code, message, file=file, line=line,
                    severity=severity, analyzer=analyzer)
        self.findings.append(f)
        return f

    def extend(self, findings):
        self.findings.extend(findings)
        return self

    def by_severity(self, sev):
        return [f for f in self.findings if f.severity == sev]

    @property
    def errors(self):
        return self.by_severity(Severity.ERROR)

    @property
    def warnings(self):
        return self.by_severity(Severity.WARNING)

    @property
    def ok(self):
        return not self.errors

    @property
    def exit_code(self):
        return 1 if self.errors else 0

    def codes(self):
        return sorted({f.code for f in self.findings})

    def sorted(self):
        return sorted(
            self.findings,
            key=lambda f: (f.file or "", f.line or 0,
                           -severity_rank(f.severity), f.code))

    def summary(self):
        return (f"{len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s), "
                f"{len(self.by_severity(Severity.INFO))} info "
                f"in {len(self.findings)} finding(s)")

    def format(self):
        lines = [f.format() for f in self.sorted()]
        lines.append(self.summary())
        return "\n".join(lines)

    def record(self):
        """Feed the monitor registry: analysis/<code>/findings per
        finding + one analysis/checks tick."""
        from ..core import monitor as _monitor

        _monitor.stat_add("analysis/checks", 1)
        for f in self.findings:
            _monitor.stat_add(f"analysis/{f.code}/findings", 1)
        return self
