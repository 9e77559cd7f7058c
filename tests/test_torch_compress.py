"""The port's quantize / dequantize and the allreduce's bookkeeping held
against the JAX package's `distributed.compress`, on the CPU (where the
int8 kernels' wrappers take their plain versions).

Tolerances, each with its reason:

  * plain versions against JAX's eager `quantize_ref` /
    `dequantize_ref`: bit for bit, int8 and fp8, zero, NaN and Inf
    blocks included (NaN compared as NaN). Both divide as written.
  * against JAX's Pallas kernels in interpret mode (and its jitted
    `quantize_ref`): XLA rewrites `absmax / 127` as `absmax *
    f32(1/127)` under jit, so a scale may be one ulp away; the codes
    are equal wherever the scales are equal, and the dequantize is bit
    for bit given the same codes and scales (one multiplication).
  * sizes, padding and wire bytes: exact integers.

Subnormal inputs are the one known divergence from the JAX package on
the CPU: XLA:CPU flushes them to zero, so a block of subnormals gets
scale 1 and codes 0 there, while the port (and the card) divides them
as IEEE floats. `test_subnormal_block_keeps_its_scale` holds the port
to the IEEE result.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.distributed import compress as jax_comp
from paddle_tpu.distributed.compress import kernels as JK
from paddle_tpu.distributed.compress import pack as jax_pack

from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.distributed import compress as comp
from paddle_tpu_torch.distributed.compress import kernels as PK
from paddle_tpu_torch.distributed.compress import pack as port_pack
from paddle_tpu_torch.incubate.nn import kernels


def _special_blocks(rng, block, nb=8):
    """nb blocks of `block`: randn x 3, with a zero block, NaN, +Inf and
    -Inf blocks, a block of exact half-way multiples of its scale and
    +-absmax, and a large-valued block."""
    x = (3 * rng.randn(nb, block)).astype(np.float32)
    x[1] = 0
    x[2, 5] = np.nan
    x[3, 7] = np.inf
    x[4, 2] = -np.inf
    # scale 1: codes of k + 0.5 round half to even; +-127 is +-absmax
    x[5] = rng.randint(-120, 120, block) + 0.5
    x[5, :2] = [127.0, -127.0]
    x[6] = (1e30 * rng.randn(block)).astype(np.float32)
    return x.reshape(-1)


def _both(x, block, mode):
    jq, js = JK.quantize_ref(jnp.asarray(x), block, mode)
    pq, ps = PK.quantize_ref(torch.from_numpy(x), block, mode)
    jd = JK.dequantize_ref(jq, js, block, mode)
    pd = PK.dequantize_ref(pq, ps, block, mode)
    return ((np.asarray(jq.astype(jnp.float32)), np.asarray(js),
             np.asarray(jd)),
            (pq.float().numpy(), ps.numpy(), pd.numpy()))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("block", [128, 256, 1024])
def test_plain_versions_match_jax_eager(mode, block):
    x = _special_blocks(np.random.RandomState(block), block)
    (jq, js, jd), (pq, ps, pd) = _both(x, block, mode)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pq, jq)
    np.testing.assert_array_equal(pd, jd)
    s = ps.reshape(-1)
    assert s[1] == 1.0 and not pd.reshape(8, block)[1].any()   # zero block
    assert s[2] == 1.0 and np.isinf(s[3]) and np.isinf(s[4])
    if mode == "int8":
        q = pq.reshape(8, block)
        assert q[2, 5] == 0 and np.isfinite(pd.reshape(8, block)[2]).all()
        assert (q[3] == 0).all() and np.isnan(pd.reshape(8, block)[3]).any()
        assert q[5, 0] == 127 and q[5, 1] == -127
        half = x.reshape(8, block)[5, 2:]
        np.testing.assert_array_equal(q[5, 2:], np.round(half))  # to even


def test_int8_codes_and_scale_dtypes():
    x = torch.randn(3, 256)
    q, s = comp.kernels.quantize_blocks(x, 128, "int8")
    assert q.dtype == torch.int8 and q.shape == x.shape and s.shape == (6,)
    q8, _ = comp.kernels.quantize_blocks(x, 128, "fp8")
    assert q8.dtype == torch.bfloat16
    assert PK.wire_dtype("int8") == torch.int8
    assert [PK.wire_itemsize(m) for m in ("fp32", "int8", "fp8")] == \
        [JK.wire_itemsize(m) for m in ("fp32", "int8", "fp8")] == [4, 1, 2]


@pytest.mark.parametrize("block", [128, 256, 1024])
def test_plain_versions_vs_pallas_interpret(block):
    """Scales within one ulp of the Pallas kernel's, codes equal where
    the scales are equal, dequantize bit for bit on the same codes and
    scales."""
    rng = np.random.RandomState(7)
    x = _special_blocks(rng, block, nb=64)
    kq, ks = JK._quantize_pallas_i8(jnp.asarray(x), block, True)
    kq, ks = np.asarray(kq), np.asarray(ks)
    pq, ps = PK.quantize_ref(torch.from_numpy(x), block, "int8")
    pq, ps = pq.numpy(), ps.numpy()
    fin = np.isfinite(ks)
    np.testing.assert_array_equal(np.isfinite(ps), fin)
    ulps = np.abs(ps[fin].view(np.int32) - ks[fin].view(np.int32))
    assert ulps.max() <= 1, ulps.max()
    same = ps == ks
    np.testing.assert_array_equal(pq.reshape(-1, block)[same],
                                  kq.reshape(-1, block)[same])
    kd = JK._dequantize_pallas_i8(jnp.asarray(kq), jnp.asarray(ks), block,
                                  True)
    pd = PK.dequantize_ref(torch.from_numpy(kq.copy()),
                           torch.from_numpy(ks.copy()), block, "int8")
    np.testing.assert_array_equal(pd.numpy(), np.asarray(kd))


def test_seed0_scale_one_ulp_from_jitted_jax():
    """randn(64, 256), seed 0, block 256: the jitted JAX path multiplies
    by f32(1/127), and two of the 64 scales land one ulp from the true
    division, which the port and JAX's eager oracle share."""
    x = np.random.RandomState(0).randn(64, 256).astype(np.float32)
    eager = np.asarray(JK.quantize_ref(jnp.asarray(x), 256, "int8")[1])
    jitted = np.asarray(jax.jit(
        lambda a: JK.quantize_ref(a, 256, "int8")[1])(jnp.asarray(x)))
    interp = np.asarray(JK._quantize_pallas_i8(jnp.asarray(x), 256, True)[1])
    port = PK.quantize_ref(torch.from_numpy(x), 256, "int8")[1].numpy()
    np.testing.assert_array_equal(port, eager)
    np.testing.assert_array_equal(jitted, interp)
    diff = port != jitted
    assert diff.sum() == 2, diff.sum()
    assert (np.abs(port[diff].view(np.int32)
                   - jitted[diff].view(np.int32)) == 1).all()


def test_subnormal_block_keeps_its_scale():
    """A block of subnormals: scale = absmax / 127 as an IEEE division
    (numpy's f32), possibly 0; codes of x / 0 clamp to +-127 and 0 / 0
    is code 0; every such block dequantizes to finite values."""
    rng = np.random.RandomState(3)
    x = np.zeros((3, 128), np.float32)
    x[0] = (rng.randn(128) * 1e-40).astype(np.float32)
    x[1, 3] = np.float32(1.4e-45)             # absmax / 127 rounds to 0
    x[2, :2] = [np.float32(1e-39), np.float32(-5e-40)]
    q, s = PK.quantize_ref(torch.from_numpy(x.reshape(-1)), 128, "int8")
    amax = np.abs(x).max(axis=1)
    np.testing.assert_array_equal(s.numpy(), amax / np.float32(127.0))
    assert s[1] == 0 and q.view(3, 128)[1, 3] == 127
    assert (q.view(3, 128)[1, :3] == 0).all()
    d = PK.dequantize_ref(q, s, 128, "int8")
    assert torch.isfinite(d).all()
    assert q.view(3, 128)[2, 0] == 127
    # the reference on XLA:CPU flushes the subnormals: scale 1, codes 0
    jq, js = JK.quantize_ref(jnp.asarray(x.reshape(-1)), 128, "int8")
    np.testing.assert_array_equal(np.asarray(js), [1.0, 1.0, 1.0])
    assert not np.asarray(jq).any()


def test_nan_in_a_block_dequantizes_finite_inf_does_not():
    """One quantize / dequantize round trip: a NaN element becomes code
    0 with scale 1, so its block comes back finite; an Inf gives scale
    inf and NaN. Both packages."""
    x = np.linspace(-1, 1, 256).astype(np.float32)
    x[5] = np.nan
    x[200] = np.inf
    jq, js = JK.quantize_ref(jnp.asarray(x), 128, "int8")
    jd = np.asarray(JK.dequantize_ref(jq, js, 128, "int8"))
    pq, ps = PK.quantize_ref(torch.from_numpy(x), 128, "int8")
    pd = PK.dequantize_ref(pq, ps, 128, "int8").numpy()
    for d in (jd, pd):
        assert np.isfinite(d[:128]).all() and d[5] == 0
        assert np.isnan(d[128:]).all()


def test_wrappers_take_plain_versions_on_cpu_and_count_nothing():
    x = torch.randn(4, 512)
    before = kernels.launches()
    q, s = PK.quantize_blocks(x, 256, "int8")
    d = PK.dequantize_blocks(q, s, 256, "int8")
    assert kernels.launches() == before
    q0, s0 = PK.quantize_ref(x, 256, "int8")
    assert torch.equal(q, q0) and torch.equal(s, s0)
    assert torch.equal(d, PK.dequantize_ref(q0, s0, 256, "int8"))


def test_wrappers_reject_other_devices_and_bad_sizes():
    with pytest.raises(ValueError, match="CUDA"):
        PK.quantize_blocks(torch.empty(256, device="meta"), 128, "int8")
    with pytest.raises(ValueError, match="CUDA"):
        PK.dequantize_blocks(torch.empty(256, dtype=torch.int8,
                                         device="meta"),
                             torch.empty(2, device="meta"), 128, "int8")
    with pytest.raises(ValueError, match="multiple"):
        PK.quantize_ref(torch.randn(300), 128, "int8")


def test_spec_grammar_matches_jax(monkeypatch):
    for spec in ("int8", "int8:ef", "fp8:block=256", "fp32",
                 "INT8:EF:block=512", "off", "", "none"):
        j, p = jax_comp.parse_spec(spec), comp.parse_spec(spec)
        assert (j is None) == (p is None)
        if p is not None:
            assert (p.mode, p.ef, p.block, p.spec()) == \
                (j.mode, j.ef, j.block, j.spec())
    for bad in ("int4", "int8:foo", "int8:block=100", "fp32:ef",
                "int8:block=x"):
        with pytest.raises(ValueError):
            jax_comp.parse_spec(bad)
        with pytest.raises(ValueError):
            comp.parse_spec(bad)
    monkeypatch.setenv("PADDLE_COMM_BLOCK", "256")
    assert comp.parse_spec("int8").block == 256
    assert comp.resolve(comp.CompressConfig("fp8")) == \
        comp.CompressConfig("fp8", block=256)
    assert comp.resolve(None) is None and comp.resolve(False) is None


def test_bad_env_spec_is_counted_warned_and_ignored(monkeypatch):
    monkeypatch.setenv("PADDLE_COMM_COMPRESS", "int9:ef")
    before = monitor.stat_get("comm/compress/spec_errors")
    with pytest.warns(UserWarning, match="PADDLE_COMM_COMPRESS"):
        assert comp.resolve(True) is None
    assert monitor.stat_get("comm/compress/spec_errors") == before + 1
    monkeypatch.setenv("PADDLE_COMM_COMPRESS", "int8:ef:block=256")
    assert comp.resolve(True) == comp.CompressConfig("int8", True, 256)


def test_sizes_and_wire_bytes_match_jax():
    cfgs = [None] + [c for s in ("fp32", "int8", "int8:ef:block=256",
                                 "fp8:block=128", "int8:block=2048")
                     for c in [comp.parse_spec(s)]]
    jcfgs = [None] + [jax_comp.parse_spec(s) for s in (
        "fp32", "int8", "int8:ef:block=256", "fp8:block=128",
        "int8:block=2048")]
    for total in (0, 1, 127, 676, 1000, 4096, 65537, 354871296):
        for w in (1, 2, 3, 4, 8):
            for pc, jc in zip(cfgs, jcfgs):
                assert comp.padded_elems(pc, total, w) == \
                    jax_comp.padded_elems(jc, total, w)
                if pc is None:
                    continue
                blk = comp.effective_block(pc, max(total, 1), w)
                assert blk == jax_comp.effective_block(jc, max(total, 1), w)
                L = comp.padded_len(total, w, blk)
                assert L == jax_comp.padded_len(total, w, blk)
                assert comp.wire_bytes_of(pc, L, block=blk) == \
                    jax_comp.wire_bytes_of(jc, L, block=blk)
    # GPT-2 345M's packed gradient at W = 2, block 1024
    c = comp.parse_spec("int8:ef")
    L = comp.padded_elems(c, 354871296, 2)
    assert comp.wire_bytes_of(c, L, 1024) == 357643728
    assert comp.wire_bytes_of(comp.parse_spec("fp32"), 354871296) == \
        1419485184


def test_account_counts_one_allreduce():
    cfg = comp.parse_spec("int8:block=128")
    keys = ("calls", "bytes", "wire_bytes")
    before = [monitor.stat_get(f"comm/all_reduce/{k}") for k in keys]
    wire = comp.account(cfg, 4000, 1024, block=128)
    after = [monitor.stat_get(f"comm/all_reduce/{k}") for k in keys]
    assert wire == 1024 + 2 * 8 * 4
    assert [a - b for a, b in zip(after, before)] == [1, 4000, wire]


def test_pack_matches_jax_and_roundtrips():
    rng = np.random.RandomState(2)
    shapes = {"b": (7,), "a": (3, 5), "c": (2, 2, 2)}
    arrays = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    names = sorted(shapes)
    jsegs = jax_pack.segments(names, arrays)
    tens = {n: torch.from_numpy(a) for n, a in arrays.items()}
    psegs = port_pack.segments(names, tens)
    assert psegs == jsegs and port_pack.total_elems(psegs) == 30
    jflat = np.asarray(jax_pack.pack_flat(jsegs, arrays, 40))
    pflat = port_pack.pack_flat(psegs, tens, 40)
    np.testing.assert_array_equal(pflat.numpy(), jflat)
    out = port_pack.unpack_flat(psegs, pflat, shapes)
    for n in names:
        assert torch.equal(out[n], tens[n])
    bf = {n: t.bfloat16() for n, t in tens.items()}
    assert port_pack.pack_flat(psegs, bf, 30).dtype == torch.float32
    with pytest.raises(ValueError):
        port_pack.pack_flat(psegs, tens, 29)


def test_single_process_allreduce_is_the_identity_and_reduce_tree_mean():
    """No process group: W = 1. all_reduce_flat returns the (quantized)
    buffer's own sum, reduce_tree its mean in each dtype."""
    x = torch.randn(1024)
    for spec in ("fp32", "int8:block=128", "fp8:block=128"):
        cfg = comp.parse_spec(spec)
        out, res = comp.all_reduce_flat(x, group=None, cfg=cfg)
        assert res is None
        want = x if cfg.mode == "fp32" else PK.dequantize_ref(
            *PK.quantize_ref(x, 128, cfg.mode), 128, cfg.mode)
        assert torch.equal(out, want)
    cfg = comp.parse_spec("int8:ef:block=128")
    r = torch.zeros_like(x)
    out, r2 = comp.all_reduce_flat(x, group=None, cfg=cfg, residual=r)
    assert torch.equal(x - out, r2)        # one rank owns every segment
    g = {"w": torch.randn(10, 10).bfloat16(), "b": torch.randn(10)}
    segs = port_pack.segments(["b", "w"], g)
    mean, _ = comp.reduce_tree(g, segs, group=None,
                              cfg=comp.parse_spec("fp32"))
    assert mean["w"].dtype == torch.bfloat16 and torch.equal(mean["w"],
                                                             g["w"])
    assert torch.equal(mean["b"], g["b"])
