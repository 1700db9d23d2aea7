"""The port's normal product ``(AᵀA x, A x)`` held against the JAX
package's Pallas kernel ``batched_normal_matvec``, run as
tests/test_pallas.py runs it (interpret mode on the CPU).

Tolerances, relative to the largest entry of the reference (entries
that cancel are held to the same absolute error as the rest):
- f32 blocks: rtol 1e-5 (two f32 sums in different orders);
- bf16 / f16 storage with an f32 x: rtol 1e-5 (both sides widen the same
  narrow values and accumulate in f32);
- f64 blocks: rtol 1e-12.
The kernel itself runs only on the card: the ``cuda``-marked test holds
it to the plain version there and skips without one. Its schedule is
tested here: the plan's row split and segment lists, and a plain-torch
replay of that schedule held against the Pallas kernel.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pylops_mpi_tpu.ops.pallas_kernels import batched_normal_matvec
from pylops_mpi_tpu_torch.ops import normal_kernels as nk

CASES = {  # name: (torch storage, jax storage, x dtype, rtol)
    "f32": (torch.float32, jnp.float32, np.float32, 1e-5),
    "bf16": (torch.bfloat16, jnp.bfloat16, np.float32, 1e-5),
    "f16": (torch.float16, jnp.float16, np.float32, 1e-5),
    "f64": (torch.float64, jnp.float64, np.float64, 1e-12),
}


def close(got, want, rtol):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               rtol=rtol, atol=rtol * np.max(np.abs(want)))


def _inputs(rng, nblk, m, n, tdt, xdt):
    # values on the narrow grid, so both packages store the same numbers
    A = rng.standard_normal((nblk, m, n)).astype(np.float32)
    A = torch.from_numpy(A).to(tdt).to(torch.float64).numpy()
    X = rng.standard_normal((nblk, n)).astype(xdt)
    return A, X


@pytest.mark.parametrize("shape", [(8, 64, 48), (8, 40, 24), (3, 16, 33)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas(rng, name, shape):
    tdt, jdt, xdt, rtol = CASES[name]
    A, X = _inputs(rng, *shape, tdt, xdt)
    uj, qj = batched_normal_matvec(jnp.asarray(A, dtype=jdt), jnp.asarray(X))
    At, Xt = torch.from_numpy(A).to(tdt), torch.from_numpy(X)
    ut, qt = nk.normal_matvec_plain(At, Xt)
    assert ut.dtype == Xt.dtype and qt.dtype == Xt.dtype
    assert np.asarray(uj).dtype == X.dtype
    close(qt.numpy(), qj, rtol)
    close(ut.numpy(), uj, rtol)


def test_wrapper_takes_plain_version_on_cpu(rng):
    A, X = _inputs(rng, 2, 9, 7, torch.float32, np.float32)
    At, Xt = torch.from_numpy(A).float(), torch.from_numpy(X)
    nk.reset_launches()
    u, q = nk.normal_matvec(At, Xt)
    u2, q2 = nk.normal_matvec_plain(At, Xt)
    assert torch.equal(u, u2) and torch.equal(q, q2)
    assert nk.launches == 0  # the kernel never ran


@pytest.mark.parametrize("A_shape,X_shape,adt,xdt,match", [
    ((2, 3, 4), (2, 5), torch.float32, torch.float32, "does not match"),
    ((3, 4), (3, 4), torch.float32, torch.float32, "nblk, m, n"),
    ((2, 3, 4), (2, 4), torch.bfloat16, torch.bfloat16, "float32"),
    ((2, 3, 4), (2, 4), torch.float32, torch.float64, "float32"),
    ((2, 3, 4), (2, 4), torch.complex64, torch.complex64, "float32"),
])
def test_wrapper_rejects(A_shape, X_shape, adt, xdt, match):
    with pytest.raises(ValueError, match=match):
        nk.normal_matvec(torch.zeros(A_shape, dtype=adt),
                         torch.zeros(X_shape, dtype=xdt))


def _old_gate(n, a_dtype):
    """The PR-1 kernel's gate: one row of A beside x and the partial u
    in the shared memory of one CTA."""
    acc = 8 if a_dtype == torch.float64 else 4
    off = (2 * n * acc + acc + 15) // 16 * 16
    return off + n * a_dtype.itemsize <= 232448


def _old_widest(a_dtype):
    n = 1
    while _old_gate(n + 1, a_dtype):
        n += 1
    return n


_NARROW = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_PLAN_CASES = [(shape, dt) for shape in [(32, 4096, 4096), (1, 8191, 4096),
                                         (300, 64, 48), (3, 1000, 777),
                                         (5, 33, 1)]
               for dt in _NARROW] + [((2, 37, _old_widest(dt)), dt)
                                     for dt in _NARROW]


@pytest.mark.parametrize("shape,a_dtype", _PLAN_CASES,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}-{str(d)[6:]}"
                              for s, d in _PLAN_CASES])
@pytest.mark.parametrize("ctas_per_sm", [1, 2])
def test_tile_plan(shape, a_dtype, ctas_per_sm):
    nblk, m, n = shape
    sm = 132
    p = nk.plan(nblk, m, n, a_dtype, sm, ctas_per_sm)
    assert p is not None
    assert nk.supported(a_dtype, nk._X_DTYPE[a_dtype], n)  # old gate held
    # CTA ranges: contiguous, non-empty, cover every row once, even split
    assert p.ctas == len(p.cta_rows) <= sm * ctas_per_sm
    assert p.cta_rows[0][0] == 0 and p.cta_rows[-1][1] == nblk * m
    assert all(a[1] == b[0] for a, b in zip(p.cta_rows, p.cta_rows[1:]))
    sizes = [e - s for s, e in p.cta_rows]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # each block's segments: contiguous, ordered by CTA, inside its CTA
    slots = set()
    for b, segs in enumerate(p.segments):
        assert segs[0][2] == b * m and segs[-1][3] == (b + 1) * m
        for (slot, cta, s, e), nxt in zip(segs, segs[1:] + (None,)):
            assert slot == cta + b and s < e
            cs, ce = p.cta_rows[cta]
            assert cs <= s and e <= ce
            if nxt is not None:
                assert nxt[1] == cta + 1 and nxt[2] == e
            slots.add(slot)
    assert len(slots) == sum(len(s) for s in p.segments)
    assert max(slots) < p.scratch_slots
    # the ring and the registers
    item = a_dtype.itemsize
    assert p.kc * nk._CONSUMERS * (16 // item) >= n
    assert 1 <= p.stages <= nk._MAX_STAGES
    assert p.stage_bytes % 128 == 0
    assert p.stage_bytes >= p.rows_per_stage * n * item + 16
    assert p.smem_bytes == nk._HEADER + p.stages * p.stage_bytes
    assert p.smem_bytes <= nk._SMEM_CTA_MAX
    assert ctas_per_sm * (p.smem_bytes + nk._SMEM_RESERVED) <= nk._SMEM_SM
    if shape == (32, 4096, 4096):
        # the main path: a deep ring, and scratch far below A's bytes
        assert p.stages >= 3 and p.rows_per_stage * n * item >= 16384
        acc = nk._X_DTYPE[a_dtype].itemsize
        assert p.scratch_slots * n * acc <= 0.01 * nblk * m * n * item


@pytest.mark.parametrize("a_dtype", _NARROW)
def test_supported_keeps_old_gate(a_dtype):
    xdt = nk._X_DTYPE[a_dtype]
    widest = _old_widest(a_dtype)
    assert all(nk.supported(a_dtype, xdt, n) for n in range(1, widest + 1))
    assert not nk.supported(a_dtype, xdt, 60000)  # too wide: two-sweep
    assert not nk.supported(a_dtype, torch.complex64, 16)
    assert not nk.supported(torch.complex128, torch.complex128, 16)
    if a_dtype != torch.float64:
        assert not nk.supported(a_dtype, torch.float64, 16)


def _replay(A, X, p):
    """The kernel's schedule in plain torch: walk each CTA's rows, form
    one partial u per block segment, sum each block's segments in order."""
    nblk, m, n = A.shape
    rows = A.to(X.dtype).reshape(nblk * m, n)
    Q = torch.empty(nblk * m, dtype=X.dtype)
    part, walked = {}, [[] for _ in range(nblk)]
    for i, (lo, hi) in enumerate(p.cta_rows):
        g = lo
        while g < hi:
            b = g // m
            end = min(hi, (b + 1) * m)
            q = rows[g:end] @ X[b]
            Q[g:end] = q
            part[i + b] = rows[g:end].T @ q
            walked[b].append((i + b, i, g, end))
            g = end
    assert tuple(tuple(w) for w in walked) == p.segments
    U = torch.zeros((nblk, n), dtype=X.dtype)
    for b, segs in enumerate(p.segments):
        for slot, *_ in segs:
            U[b] += part[slot]
    return U, Q.view(nblk, m)


@pytest.mark.parametrize("shape,sm", [((8, 64, 48), 5), ((3, 16, 33), 4),
                                      ((5, 33, 1), 3)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_replay_matches_pallas(rng, name, shape, sm):
    tdt, jdt, xdt, rtol = CASES[name]
    A, X = _inputs(rng, *shape, tdt, xdt)
    p = nk.plan(*shape, tdt, sm)
    crossing = [s for s, e in p.cta_rows if s % shape[1]]
    assert crossing  # ranges start inside blocks: the segments matter
    uj, qj = batched_normal_matvec(jnp.asarray(A, dtype=jdt), jnp.asarray(X))
    ut, qt = _replay(torch.from_numpy(A).to(tdt), torch.from_numpy(X), p)
    close(qt.numpy(), qj, rtol)
    close(ut.numpy(), uj, rtol)


# (3, 1000, 777) ragged; (4, 50, 33) and (5, 33, 1) narrow and unaligned;
# (1, 8191, 4096) one tall block; (300, 64, 48) many small blocks; the
# last, A as a view one element past an aligned base.
_CARD_SHAPES = [(3, 1000, 777), (4, 50, 33), (5, 33, 1), (1, 8191, 4096),
                (300, 64, 48), (3, 1000, 777, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["f32", "bf16", "f16", "f64"])
def test_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not here)")
    tdt, _, xdt, _ = CASES[name]
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in _CARD_SHAPES:
        nblk, m, n, *off = shape + (0,) if len(shape) == 3 else shape
        base = torch.randn(nblk * m * n + off[0], generator=g,
                           device="cuda").to(tdt)
        A = base[off[0]:].view(nblk, m, n)
        X = torch.randn((nblk, n), generator=g, device="cuda",
                        dtype=torch.float64 if tdt == torch.float64
                        else torch.float32)
        nk.reset_launches()
        u, q = nk.normal_matvec(A, X)
        u1, q1 = nk.normal_matvec(A, X)
        torch.cuda.synchronize()
        assert nk.launches == 2
        assert torch.equal(u, u1) and torch.equal(q, q1)  # deterministic
        u2, q2 = nk.normal_matvec_plain(A, X)
        tol = 1e-12 if tdt == torch.float64 else 1e-4
        for got, want in ((u, u2), (q, q2)):
            err = (got - want).abs().max() / want.abs().max()
            assert float(err) <= tol, shape


def test_build_needs_nvcc_and_keys_on_sources(tmp_path, monkeypatch):
    from pylops_mpi_tpu_torch.ops import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if _build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    target = _build._target("normal_matvec")
    assert target.parent == _build.BUILD_DIR
    assert target.name.startswith("libnormal_matvec-") and \
        target.suffix == ".so"
