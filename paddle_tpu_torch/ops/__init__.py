"""paddle_tpu_torch.ops — the functional op library, at the JAX
package's module paths (`paddle_tpu/ops/`): `creation`, `math`,
`logic`, `manipulation`, `linalg`, `search`, `random`, `activation`,
`conv`, `norm_ops` and `loss_ops`. Each op hands its tensor inputs to
`amp.maybe_cast_inputs` under its JAX op name first, as the JAX
dispatcher does, so `amp.auto_cast` (O1) sees it.

`PUBLIC_OPS` flattens the modules' `__all__` into one {name: op} map,
the first module's op winning a name two modules export, as the JAX
package's `_collect_public` (:36-47) does; the map's names are bound
here and at the package root. They include `abs`, `sum`, `max`, `min`,
`all`, `any`, `round` and `pow`, which shadow the builtins in this
module: nothing below the binding uses a builtin.
"""
from . import creation
from . import math
from . import logic
from . import manipulation
from . import linalg
from . import search
from . import random
from . import activation
from . import conv
from . import norm_ops
from . import loss_ops

_MODULES = [
    creation,
    math,
    logic,
    manipulation,
    linalg,
    search,
    random,
    activation,
    conv,
    norm_ops,
    loss_ops,
]


def _collect_public():
    out = {}
    for mod in _MODULES:
        names = getattr(mod, "__all__", None) or [
            n for n in dir(mod) if not n.startswith("_")
        ]
        for n in names:
            fn = getattr(mod, n, None)
            if callable(fn):
                out.setdefault(n, fn)
    return out


PUBLIC_OPS = _collect_public()
globals().update(PUBLIC_OPS)
