"""paddle_tpu_torch.analysis: the runtime half of `paddle_tpu.analysis`
that the sanitizer and `amp` call. `diagnostics` (`Finding`, `Report`),
`precision` (the PTA092 autocast and PTA093 train-step audits) and the
`PADDLE_ANALYSIS` opt-in. The static passes (the AST and trace linters,
`python -m paddle_tpu.analysis`) are not ported (ROADMAP queue 1 item
4, "Waits")."""
from __future__ import annotations

import os

__all__ = ["enabled", "diagnostics", "precision"]


def enabled():
    """True when the PADDLE_ANALYSIS env opt-in is on."""
    return os.environ.get("PADDLE_ANALYSIS", "").strip().lower() \
        not in ("", "0", "false", "off")


from . import diagnostics, precision  # noqa: E402
