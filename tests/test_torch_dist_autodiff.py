"""Gradients across ranks: gloo worlds of 2 and 3 ranks on the CPU.

- The collectives' autograd rules pass the dot-product adjoint test:
  ``all_reduce("sum")`` (a replicated output: its cotangent is the same
  on every rank and counted once), ``all_gather`` and ``reduce_scatter``
  (per-rank on both sides, summed over the ranks), ``halo_exchange`` and
  ``cart_halo_extend`` (each ghost's cotangent sent home), ``all_to_all``
  (the cotangents sent back with the shapes swapped) and ``exchange``
  (a ring: each received buffer's cotangent back to its sender).
  ``all_reduce`` ``max``/``min`` and ``broadcast`` refuse a tensor that
  requires grad under grad mode, naming why.
- ``examples/autodiff.py``'s objective (``MPIBlockDiag`` and the axis-0
  ``MPIFirstDerivative``, whose tap rule sends its ghost cotangents home)
  gives every rank its shard of the one-rank gradient, and 20 steps of
  gradient descent by autograd land where the one-rank steps land.
- ``cgls_solve`` on ``MPIStackedVStack([Op, ε·MPIGradient-like D])``:
  the implicit gradients with respect to ``y`` and ``ε`` equal the
  one-rank ones.

The one-rank references run in this process (the port without a group)
while the worlds work. Tolerances: adjoint tests 1e-12 relative, the
gradients 1e-12 (f64), the implicit ones 1e-9.
"""

import numpy as np
import pytest
import torch

from test_torch_process_group import close, run_world

WORLDS = [2, 3]
NBLK, NB = 6, 8
N = NBLK * NB
STEPS = 20


def make_data():
    rng = np.random.default_rng(5)
    blocks = [rng.standard_normal((NB, NB)) + NB * np.eye(NB)
              for _ in range(NBLK)]
    x_true = np.cumsum(rng.standard_normal(N)) / 4
    y = np.concatenate([b @ x_true[i * NB:(i + 1) * NB]
                        for i, b in enumerate(blocks)])
    return dict(blocks=blocks, y=y, x=rng.standard_normal(N),
                g5=rng.standard_normal(5), w=rng.standard_normal(N))


def _objective_grads(d, device="cpu"):
    """examples/autodiff.py's objective: its gradient at ``d["x"]`` (this
    rank's shard), the hand-written one, and the iterate after STEPS
    steps of gradient descent by autograd (this rank's shard)."""
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    Aop = pmtt.convert.blockdiag_from_numpy(d["blocks"], device=device)
    Dop = pmtt.MPIFirstDerivative((N,), dtype=torch.float64)
    dy = D.to_dist(d["y"], local_shapes=Aop.local_shapes_n, device=device)

    def objective(x):
        r = Aop.matvec(x) - dy
        dd = Dop.matvec(x)
        return 0.5 * r.dot(r) + 0.05 * dd.dot(dd)

    x = D.to_dist(d["x"], local_shapes=Aop.local_shapes_m, device=device)
    x.array.requires_grad_(True)
    (g,) = torch.autograd.grad(objective(x), x.array)
    with torch.no_grad():
        xx = D.to_dist(d["x"], local_shapes=Aop.local_shapes_m,
                       device=device)
        hand = (Aop.rmatvec(Aop.matvec(xx) - dy).array
                + 0.1 * Dop.rmatvec(Dop.matvec(xx)).array)
    xs = D.to_dist(np.zeros(N), local_shapes=Aop.local_shapes_m,
                   device=device)
    for _ in range(STEPS):
        xs.array.requires_grad_(True)
        (gs,) = torch.autograd.grad(objective(xs), xs.array)
        xs = D._wrap((xs.array - 5e-4 * gs).detach(), xs)
    return g.numpy(), hand.numpy(), xs.array.numpy()


def _implicit_grads(d, device="cpu"):
    """cgls_solve on [A; ε·D]: the gradients of ⟨w, x⟩ with respect to
    this rank's shard of y and to ε."""
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch.autodiff import cgls_solve
    Aop = pmtt.convert.blockdiag_from_numpy(d["blocks"], device=device)
    eps = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    Dop = pmtt.MPIFirstDerivative((N,), dtype=torch.float64)
    S = pmtt.MPIStackedVStack([Aop, eps * Dop])
    y = D.to_dist(d["y"], local_shapes=Aop.local_shapes_n, device=device)
    y.array.requires_grad_(True)
    z = D.to_dist(np.zeros(N), local_shapes=Dop.local_shapes_n,
                  device=device)
    x = cgls_solve(S, pmtt.StackedDistributedArray([y, z]), niter=60,
                   damp=1e-3, tol=0.0)
    w = D.to_dist(d["w"], local_shapes=Aop.local_shapes_m, device=device)
    gy, ge = torch.autograd.grad(x.dot(w), (y.array, eps))
    return gy.numpy(), float(ge)


def _ad_rank(d):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.parallel import collectives as co
    n, r = pmtt.parallel.world_size(), pmtt.parallel.rank()
    gen = torch.Generator().manual_seed(100 + r)

    def rand(*shape, grad=False):
        t = torch.randn(*shape, dtype=torch.float64, generator=gen)
        return t.requires_grad_(grad)

    def ranks_sum(v):
        return float(co.all_reduce(torch.tensor([float(v)],
                                                dtype=torch.float64)))

    out = {}
    co.reset_counts()
    # all_reduce(sum): replicated output, its cotangent counted once
    x = rand(5, grad=True)
    gr = torch.as_tensor(d["g5"])
    y = co.all_reduce(x, "sum")
    (gx,) = torch.autograd.grad(y, x, gr)
    out["all_reduce"] = (float(torch.dot(y.detach(), gr)),
                         ranks_sum(torch.dot(x.detach(), gx)))
    out["x_untouched"] = bool(not torch.equal(x.detach(), y.detach()))
    refused = []
    for op in ("max", "min"):
        try:
            co.all_reduce(x, op)
        except NotImplementedError as e:
            refused.append(str(e))
    # all_gather and reduce_scatter: per-rank on both sides
    sizes = [q + 2 for q in range(n)]
    xs = rand(sizes[r], 3, grad=True)
    yg = co.all_gather(xs, sizes)
    gg = rand(*yg.shape)
    (gxs,) = torch.autograd.grad(yg, xs, gg)
    out["all_gather"] = (ranks_sum(torch.sum(yg.detach() * gg)),
                         ranks_sum(torch.sum(xs.detach() * gxs)))
    t = rand(sum(sizes), 3, grad=True)
    ys = co.reduce_scatter(t, sizes)
    gs = rand(*ys.shape)
    (gt,) = torch.autograd.grad(ys, t, gs)
    out["reduce_scatter"] = (ranks_sum(torch.sum(ys.detach() * gs)),
                             ranks_sum(torch.sum(t.detach() * gt)))
    # halo_exchange: the ghosts' cotangents go home
    block = rand(4, 3, grad=True)
    top, bottom = co.halo_exchange(block, 1, 2)
    pieces = [p for p in (top, bottom) if isinstance(p, torch.Tensor)]
    cots = [rand(*p.shape) for p in pieces]
    (gb,) = torch.autograd.grad(pieces, block, cots)
    out["halo"] = (ranks_sum(sum(torch.sum(p.detach() * c)
                                 for p, c in zip(pieces, cots))),
                   ranks_sum(torch.sum(block.detach() * gb)))
    # all_to_all: ragged pieces, rank r sends q a (q + 1, r + 2) block
    sends = [rand(q + 1, r + 2, grad=True) for q in range(n)]
    got = co.all_to_all(sends, [(r + 1, p + 2) for p in range(n)])
    cots = [rand(*g.shape) for g in got]
    gsend = torch.autograd.grad(got, sends, cots)
    out["all_to_all"] = (
        ranks_sum(sum(torch.sum(g.detach() * c) for g, c in zip(got, cots))),
        ranks_sum(sum(torch.sum(t.detach() * g)
                      for t, g in zip(sends, gsend))))
    # exchange: a ring, each rank sending to the next
    ring = rand(3, 2, grad=True)
    (rx,) = co.exchange("ring", [(ring, (r + 1) % n)],
                        [((3, 2), (r - 1) % n)], ring.dtype)
    cot = rand(3, 2)
    (gring,) = torch.autograd.grad(rx, ring, cot)
    out["exchange"] = (ranks_sum(torch.sum(rx.detach() * cot)),
                       ranks_sum(torch.sum(ring.detach() * gring)))
    # cart_halo_extend along axis 0 on an (n,) grid, then along axis 1 of
    # the extended block on a (1, n) grid: ghosts of 1 and 2 slices each
    slab = rand(3, 4, grad=True)
    ext = co.cart_halo_extend(slab, (n,), 0, 1, 2)
    ext = co.cart_halo_extend(ext.movedim(0, 1).contiguous(), (1, n), 1,
                              1, 2).movedim(1, 0)
    cot = rand(*ext.shape)
    (gslab,) = torch.autograd.grad(ext, slab, cot)
    out["cart_halo_extend"] = (ranks_sum(torch.sum(ext.detach() * cot)),
                               ranks_sum(torch.sum(slab.detach() * gslab)))
    try:
        co.broadcast(xs, 0)
    except NotImplementedError as e:
        refused.append(str(e))
    out["refused"] = refused
    with torch.no_grad():   # outside grad mode nothing is refused
        co.broadcast(xs.detach().clone(), 0)
    out["first_counts"] = dict(co.counts)
    co.reset_counts()
    out["objective"] = _objective_grads(d)
    out["counts"] = dict(co.counts)
    out["implicit"] = _implicit_grads(d)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = make_data()
    one = {}

    def reference():
        one["objective"] = _objective_grads(d)
        one["implicit"] = _implicit_grads(d)
        return one

    out = {}
    for n in WORLDS:
        res, _ = run_world(_ad_rank, n, tmp_path_factory.mktemp(f"w{n}"), d,
                           during=reference if not one else (lambda: None))
        out[n] = res
    return d, one, out


@pytest.mark.parametrize("n", WORLDS)
def test_collective_rules_pass_adjoint_test(worlds, n):
    _, _, out = worlds
    for o in out[n]:
        for key in ("all_reduce", "all_gather", "reduce_scatter", "halo",
                    "all_to_all", "exchange", "cart_halo_extend"):
            lhs, rhs = o[key]
            assert rhs == pytest.approx(lhs, rel=1e-12, abs=1e-12), key
        assert o["x_untouched"]


@pytest.mark.parametrize("n", WORLDS)
def test_collectives_without_rule_refuse(worlds, n):
    """``all_reduce`` ``max``/``min`` and ``broadcast`` still refuse, each
    naming the JAX package's reason; ``all_to_all`` and
    ``cart_halo_extend``, which refused before their rules were ported,
    now carry the gradient (their adjoint tests above) and were counted
    as adjoint calls."""
    _, _, out = worlds
    for o in out[n]:
        msgs = o["refused"]
        assert len(msgs) == 3
        assert all("pmax/pmin" in m for m in msgs[:2])
        assert "JAX package has no broadcast collective" in msgs[2]
        assert not any("item 6" in m for m in msgs)
        for name in ("all_to_all", "ring", "cart_halo_extend"):
            assert o["first_counts"][name + "_adjoint"] >= 1, name


@pytest.mark.parametrize("n", WORLDS)
def test_autodiff_example_gradient_equals_one_rank(worlds, n):
    """Each rank's shard of the gradient is the one-rank gradient's (and
    the hand-written one's); the tap rule's ghost cotangents went home
    through the exchange's adjoint; gradient descent tracks."""
    _, one, out = worlds
    g1, hand1, x1 = one["objective"]
    close(hand1, g1, 1e-12)
    got = np.concatenate([o["objective"][0] for o in out[n]])
    close(got, g1, 1e-12)
    close(np.concatenate([o["objective"][1] for o in out[n]]), g1, 1e-12)
    close(np.concatenate([o["objective"][2] for o in out[n]]), x1, 1e-11)
    for r, o in enumerate(out[n]):
        c = o["counts"]
        assert c["halo_exchange_adjoint"] >= STEPS + 1
        assert c["halo_exchange_adjoint"] <= c["halo_exchange"]


@pytest.mark.parametrize("n", WORLDS)
def test_implicit_gradient_across_ranks(worlds, n):
    _, one, out = worlds
    gy1, ge1 = one["implicit"]
    close(np.concatenate([o["implicit"][0] for o in out[n]]), gy1, 1e-9)
    for o in out[n]:
        assert o["implicit"][1] == pytest.approx(ge1, rel=1e-9)
