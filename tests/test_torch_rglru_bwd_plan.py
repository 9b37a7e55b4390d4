"""B3′'s launch plan and its schedule, on the CPU.

The scan's backward kernel (``csrc/rglru_scan.cu``, ``rglru_scan_bwd_*``)
cuts time into chunks of ``B3P_STEPS`` steps that the CTAs of one thread
block cluster own in a ring, and hands only the exact adjoint (and the
exact f32 carry of its forward walk) from chunk to chunk. Here:

* ``ops._rglru_scan_backward_plan`` over a grid of (B, T, W, dtype,
  saved h): every step in exactly one chunk, every rank's chunks in ring
  order, the cluster size, shared memory, grid and the entry-carry
  scratch within what the card and the kernel take; refused shapes raise
  by name; its constants are the kernel source's;
* an emulation of the kernel's schedule (each CTA of a cluster a
  generator that walks its jobs in the kernel's order and waits for its
  hand-offs, run round robin) ``==`` ``ref.rglru_scan_backward_reference``
  in f32 and bf16, with and without h0, g_last and the saved h, at T = 1,
  T < L, T = L, T = S·L ± 1 and two laps.

The kernel itself is held to the plain version on the card by the ``gpu``
tests of ``test_torch_kernels.py`` and by ``chip_smoke.py``.
"""
import itertools
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402

CU = (Path(ops.__file__).resolve().parent / "csrc" / "rglru_scan.cu")
L, S = ops.B3P_STEPS, ops.B3P_CLUSTER
#: T = 1, T < L, T = L, T = S·L - 1, S·L + 1 (a second lap of one chunk),
#: two laps and a ragged third
TS = [1, 40, L, S * L - 1, S * L + 1, 2 * S * L, 2 * S * L + 77]
WS = [1, 5, 64, 100, 4096, 4100]


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", CU.read_text())
    assert m, f"{name} not in {CU.name}"
    return int(m.group(1))


def test_plan_constants_are_the_kernels():
    assert _constant("kBwdCh") == ops.B3P_CH
    assert _constant("kBwdSteps") == ops.B3P_STEPS
    assert _constant("kBwdMaxCluster") == ops._CLUSTER_MAX
    # the portable most: no non-portable attribute on the default plan
    assert ops.B3P_CLUSTER <= 8


@pytest.mark.parametrize("elem,has_h", [(4, True), (4, False), (2, False),
                                        (2, True)])
@pytest.mark.parametrize("T", TS)
def test_plan_covers_every_step_once(T, elem, has_h):
    for B, W in itertools.product([1, 3, ops._GRID_YZ], WS):
        p = ops._rglru_scan_backward_plan(B, T, W, elem, has_h)
        assert (p.ch, p.steps) == (ops.B3P_CH, ops.B3P_STEPS)
        assert p.chunks == -(-T // p.steps)
        assert 1 <= p.cluster <= min(ops.B3P_CLUSTER, p.chunks) <= 8
        assert p.laps == -(-p.chunks // p.cluster)
        seen = []
        for rank in range(p.cluster):
            ring = p.ring(rank)
            # every rank owns a chunk, in lap order, one a lap
            assert 1 <= len(ring) <= p.laps
            assert ring == sorted(ring)
            assert all(k % p.cluster == rank for k in ring)
            for k in ring:
                seen.extend(range(k * p.steps, min((k + 1) * p.steps, T)))
        assert sorted(seen) == list(range(T))
        assert p.grid == (-(-W // p.ch), B, p.cluster)
        assert p.grid[1] <= ops._GRID_YZ
        assert p.smem <= ops._SMEM_MAX
        slots = 2 if p.laps > 1 else 1
        assert p.smem >= slots * 3 * p.steps * p.ch * elem
        # the entry carries only where the carry is recomputed over laps
        recompute = not (has_h and elem == 4)
        want = (B, p.chunks, W) if recompute and p.laps > 1 else None
        assert p.scratch == want


@pytest.mark.parametrize("cluster", [9, 16])
def test_plan_nonportable_cluster(cluster):
    p = ops._rglru_scan_backward_plan(2, 4096, 4096, 4, True,
                                      cluster=cluster)
    assert p.cluster == cluster <= ops._CLUSTER_MAX
    assert p.laps == -(-p.chunks // cluster)
    assert sorted(k for r in range(cluster) for k in p.ring(r)) == \
        list(range(p.chunks))


@pytest.mark.parametrize("args,kw,match", [
    ((ops._GRID_YZ + 1, 8, 8, 4, True), {}, "grid"),
    ((2, 0, 8, 4, True), {}, "B, T, W >= 1"),
    ((2, 8, 8, 4, True), dict(cluster=17), "cluster"),
    ((2, 8, 8, 4, True), dict(cluster=0), "cluster"),
    # two laps of f32 tiles of 256 channels do not fit
    ((2, 4096, 4096, 4, False), dict(ch=256), "shared memory"),
])
def test_plan_refuses_by_name(args, kw, match):
    with pytest.raises(ValueError, match=match):
        ops._rglru_scan_backward_plan(*args, **kw)


def _emulate(plan, log_a, b, h0, h, g_h, g_last):
    """The kernel's schedule with the plain steps: CTA s of a cluster walks
    its chunks (``plan.ring(s)``) forwards, first lap first, where the
    carry is recomputed, then backwards, last lap first; each hand-off is
    the exact f32 value, put in the receiver's box, which must be empty
    (one message in flight a box, as the kernel's mbarrier phases
    assume); a CTA waiting for its box yields. With one lap the two walks
    of a chunk run in one job, the one whose hand-off comes first first.
    The reverse walk hands off before the outputs are written, for which
    the chunk's carries are recomputed from its entry carry (kept by the
    CTA: in a register for one lap, in the scratch for more)."""
    B, T, W = log_a.shape
    steps, S, n = plan.steps, plan.cluster, plan.chunks
    has_h = h is not None and h.dtype == torch.float32
    zeros = torch.zeros(B, W)
    hinit = zeros if h0 is None else h0.float()
    dla, db = torch.empty_like(log_a), torch.empty_like(b)
    out = {}
    fwd_box, bwd_box = [None] * S, [None] * S
    entry = {}

    def span(k):
        return range(k * steps, min((k + 1) * steps, T))

    def a_of(t):
        return torch.exp(log_a[:, t].float())

    def walk(k, c):
        hp = {}
        for t in span(k):
            hp[t] = c
            c = a_of(t) * c + b[:, t].float()
        return hp, c

    def forward(s, k):
        if k == 0:
            c = hinit
        else:
            while fwd_box[s] is None:
                yield
            c, fwd_box[s] = fwd_box[s], None
        entry[k] = c
        _, c = walk(k, c)
        if k + 1 < n:
            assert fwd_box[(s + 1) % S] is None
            fwd_box[(s + 1) % S] = c

    def reverse(s, k, lams):
        if k == n - 1:
            lam = zeros if g_last is None else g_last.float()
            a_next = torch.ones(B, W)
        else:
            while bwd_box[s] is None:
                yield
            (lam, a_next), bwd_box[s] = bwd_box[s], None
        for t in reversed(span(k)):
            lam = g_h[:, t].float() + lam * a_next
            lams[t] = lam
            a_next = a_of(t)
        if k > 0:
            assert bwd_box[(s - 1) % S] is None
            bwd_box[(s - 1) % S] = (lam, a_next)
        else:
            out["dh0"] = lam * a_next

    def cta(s):
        ring = plan.ring(s)
        # one lap: both walks of the chunk, first the one whose hand-off
        # comes first; more: every forward walk, then every reverse one
        both = not has_h and plan.laps == 1
        if not has_h and not both:
            for k in ring:
                yield from forward(s, k)
        for k in reversed(ring):
            lams = {}
            if both and 2 * k < n - 1:
                yield from forward(s, k)
                yield from reverse(s, k, lams)
            elif both:
                yield from reverse(s, k, lams)
                yield from forward(s, k)
            else:
                yield from reverse(s, k, lams)
            if has_h:
                hp = {t: hinit if t == 0 else h[:, t - 1] for t in span(k)}
            else:
                hp, _ = walk(k, entry[k])
            for t in span(k):
                db[:, t] = lams[t].to(b.dtype)
                dla[:, t] = ((lams[t] * hp[t]) * a_of(t)).to(log_a.dtype)

    # round robin; a deadlock (a ring out of order) never ends: a CTA waits
    # at most once a chunk while the others walk theirs
    running = [cta(s) for s in range(S)]
    for _ in range(4 * n + 4):
        left = []
        for g in running:
            try:
                next(g)
                left.append(g)
            except StopIteration:
                pass
        running = left
        if not running:
            return dla, db, out["dh0"]
    raise AssertionError("the schedule deadlocked")


def _inputs(B, T, W, dtype, with_h0, with_last, seed):
    rng = np.random.default_rng(seed)

    def r(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    la = torch.from_numpy(-rng.random((B, T, W)).astype(np.float32) * 0.5)
    return (la.to(dtype), r(B, T, W).to(dtype), r(B, W) if with_h0 else None,
            r(B, T, W).to(dtype), r(B, W) if with_last else None)


@pytest.mark.parametrize("saved", [True, False])
@pytest.mark.parametrize("with_h0,with_last", [(False, False), (True, True),
                                               (True, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", TS)
def test_schedule_emulation_equals_plain(T, dtype, with_h0, with_last, saved):
    B, W = 2, 3
    la, b, h0, g, gl = _inputs(B, T, W, dtype, with_h0, with_last, seed=T)
    h, _ = ref.rglru_scan_reference(la, b, h0)
    h = h if saved else None
    plan = ops._rglru_scan_backward_plan(
        B, T, W, la.element_size(),
        h is not None and h.dtype == torch.float32)
    want = ref.rglru_scan_backward_reference(la, b, h0, h, g, gl)
    got = _emulate(plan, la, b, h0, h, g, gl)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("steps,cluster", [(4, 1), (4, 3), (2, 16), (5, 2)])
def test_schedule_emulation_equals_plain_other_plans(steps, cluster):
    """Short chunks over many laps, a cluster of one CTA (it hands off to
    itself) and a non-portable cluster of 16."""
    la, b, h0, g, gl = _inputs(3, 41, 4, torch.bfloat16, True, True, seed=7)
    plan = ops._rglru_scan_backward_plan(3, 41, 4, 2, False, steps=steps,
                                         cluster=cluster)
    assert plan.laps > 1 and plan.scratch == (3, plan.chunks, 4)
    want = ref.rglru_scan_backward_reference(la, b, h0, None, g, gl)
    for x, y in zip(_emulate(plan, la, b, h0, None, g, gl), want):
        assert torch.equal(x, y)
