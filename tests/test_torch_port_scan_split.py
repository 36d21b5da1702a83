"""A CPU model of how the CUDA scan kernels split their work, in numpy.

``csrc/selective_scan_fwd.cu`` and ``csrc/selective_scan_bwd.cu`` cannot
run here, so this file replays their split of the work lane by lane, with
the lane map, the shuffles and the shared-memory layout written out, and
holds the result against the plain loops ``_scan_tm_plain`` and
``_scan_tm_plain_bwd`` in fp32 at a small shape whose DG (80) is neither a
multiple of the block's 64 channels nor below them and whose L (37) is not
a multiple of the chunk. Only the order of the fp32 sums differs (and
exp(dt A) taken as 2^(dt A log2 e)), so the gate is rtol 1e-5 against the
largest entry. What it models:

- the map from a block's thread to (channel, state entries): kP lanes a
  channel, 16 / kP neighbouring entries a lane, channels past DG masked;
- each lane's sum over its entries, then the log2 kP shuffle tree (the
  backward's sums over n, each step), or the forward's transpose-reduce of a
  chunk's 16 steps over the channel's lanes (``steps_sum``);
- the backward's transpose-reduce of dB_t and dC_t over a warp's 8
  channels, and which lane ends holding which n;
- the per-block dB/dC partials (ceil(DG / 64), batch, G, L, 16) that the
  wrapper adds up with ``torch.sum``.

The constants are read from the kernel sources, so a change there that the
model does not follow fails here.
"""

import re

import numpy as np
import pytest
import torch

from mamba_clip_tpu_torch.ops import cuda_build
from mamba_clip_tpu_torch.ops.selective_scan import (
    BLOCK_CHANNELS,
    CHUNK,
    _aligned,
    _scan_tm_plain,
    _scan_tm_plain_bwd,
)

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

N = 16
F32 = np.float32
LOG2E, LN2 = F32(1.4426950408889634), F32(0.6931471805599453)
# the n that lane l holds after the transpose-reduce, as the kernel writes it
N_OF_LANE_SRC = "4 * q + 2 * ((lane >> 2) & 1) + ((lane >> 3) & 1)"


def _source(name):
    return (cuda_build.CSRC / name).read_text()


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _p(kernel):
    return _constant(_source(f"selective_scan_{kernel}.cu"), "kP")


class Split:
    """A block of ``64 * P`` threads: thread ``tid`` is lane ``tid % 32`` of
    warp ``tid // 32`` and holds, of the block's channel ``warp * 32 / P +
    lane // P``, the entries ``q * 16 / P + j`` (q = lane % P)."""

    def __init__(self, P):
        self.P, self.E, self.WC = P, N // P, 32 // P
        self.T = BLOCK_CHANNELS * P
        tid = np.arange(self.T)
        self.warp, self.lane = tid // 32, tid % 32
        self.q = self.lane % P
        self.ch = self.warp * self.WC + self.lane // P
        self.n = self.q[None, :] * self.E + np.arange(self.E)[:, None]  # (E, T)

    def shfl_xor(self, x, o):
        """``__shfl_xor_sync(kFull, x, o)`` over the thread axis (last)."""
        return x[..., self.warp * 32 + (self.lane ^ o)]

    def channel_sum(self, x):
        o = 1
        while o < self.P:
            x = x + self.shfl_xor(x, o)
            o <<= 1
        return x

    def steps_sum(self, v):
        """``steps_sum`` of the forward: v[s] (16, ..., T), each lane's part
        of step s's sum. Returns (16 / P, ..., T): at k, the whole sum of
        step q + P k on lane q."""
        v = list(v)
        o = 1
        while o < self.P:
            hi = (self.q & o) != 0
            v = [np.where(hi, v[2 * i + 1], v[2 * i])
                 + self.shfl_xor(np.where(hi, v[2 * i], v[2 * i + 1]), o)
                 for i in range(len(v) // 2)]
            o <<= 1
        return np.stack(v)

    def transpose_reduce(self, v):
        """``transpose_reduce`` of the backward: v (4, ..., T) -> (..., T)."""
        b2, b3 = (self.lane & 4) != 0, (self.lane & 8) != 0
        w0 = np.where(b2, v[2], v[0]) + self.shfl_xor(np.where(b2, v[0], v[2]), 4)
        w1 = np.where(b2, v[3], v[1]) + self.shfl_xor(np.where(b2, v[1], v[3]), 4)
        x = np.where(b3, w1, w0) + self.shfl_xor(np.where(b3, w0, w1), 8)
        return x + self.shfl_xor(x, 16)

    def n_of_lane(self):
        lane, q = self.lane, self.q
        return eval(N_OF_LANE_SRC)


def _softplus(x):
    return (np.maximum(x, 0) + np.log1p(np.exp(-np.abs(x)))).astype(F32)


def _inputs(Bsz, G, L, DG, seed):
    rs = np.random.RandomState(seed)
    u = rs.randn(Bsz, G, L, DG).astype(F32)
    delta = (rs.randn(Bsz, G, L, DG) * 0.5).astype(F32)
    A = (-np.exp(rs.randn(G * DG, N) * 0.5)).astype(F32)
    B = rs.randn(Bsz, G, L, N).astype(F32)
    C = rs.randn(Bsz, G, L, N).astype(F32)
    D = rs.randn(G * DG).astype(F32)
    bias = (rs.randn(G * DG) * 0.1 - 2.0).astype(F32)
    dy = rs.randn(Bsz, G, L, DG).astype(F32)
    return u, delta, A, B, C, D, bias, dy


class Blocks:
    """Every block of a launch at once: axis 0 the (batch * G) row, axis 1
    the tile of 64 channels, the last axis the thread."""

    def __init__(self, sp, u, delta, A, B, C, D, bias, softplus):
        Bsz, G, L, DG = u.shape
        self.sp, self.L, self.DG = sp, L, DG
        self.n_tiles = -(-DG // BLOCK_CHANNELS)
        d_raw = np.arange(self.n_tiles)[:, None] * BLOCK_CHANNELS + sp.ch[None]  # (tiles, T)
        self.valid = d_raw < DG
        self.d = np.where(self.valid, d_raw, DG - 1)
        self.gd = (np.arange(Bsz * G) % G)[:, None, None] * DG + self.d[None]  # (BG, tiles, T)
        self.bg = np.arange(Bsz * G)[:, None, None]
        self.u = u.reshape(Bsz * G, L, DG)
        bias_bg = bias.reshape(G, DG)[np.arange(Bsz * G) % G]
        self.x = delta.reshape(Bsz * G, L, DG) + bias_bg[:, None, :]
        self.B, self.C = B.reshape(Bsz * G, L, N), C.reshape(Bsz * G, L, N)
        # A scaled by log2 e at load: a = ex2(dt * A2)
        self.A2 = np.stack([A[self.gd, sp.n[j][None, None]] * LOG2E for j in range(sp.E)])
        self.Dk = D[self.gd]
        self.softplus = softplus

    def chan(self, arr, t):
        """arr (BG, L, DG) at step t on each thread's channel: (BG, tiles, T)."""
        return arr[self.bg, t, self.d[None]]

    def staged(self, t):
        """What lane q stages for step t once a channel-step: dt, dt*u, u,
        sigmoid; zero past L and DG."""
        inside = self.valid[None] & (t < self.L)
        tt = min(t, self.L - 1)
        x, uv = self.chan(self.x, tt), self.chan(self.u, tt)
        dt = np.where(inside, _softplus(x) if self.softplus else x, F32(0))
        sig = np.where(inside & self.softplus, 1 / (1 + np.exp(-x)), F32(1)).astype(F32)
        return dt.astype(F32), (dt * uv).astype(F32), np.where(inside, uv, F32(0)), sig

    def row(self, M, t):
        """The lane's entries of a staged B or C row: (E, BG, tiles, T), zero past L."""
        if t >= self.L:
            return np.zeros((self.sp.E,) + self.gd.shape, F32)
        return np.stack([np.broadcast_to(M[:, t, self.sp.n[j]][:, None], self.gd.shape)
                         for j in range(self.sp.E)])


def model_fwd(u, delta, A, B, C, D, bias, softplus, P):
    """The forward kernel's split: y and hck."""
    sp = Split(P)
    Bsz, G, L, DG = u.shape
    k = Blocks(sp, u, delta, A, B, C, D, bias, softplus)
    h = np.zeros((sp.E,) + k.gd.shape, F32)
    y = np.zeros((Bsz * G, L, DG), F32)
    n_chunks = -(-L // CHUNK)
    hck = np.zeros((Bsz * G, n_chunks, DG, N), F32)
    for c in range(n_chunks):
        t0 = c * CHUNK
        bgi, ti, li = np.nonzero(np.broadcast_to(k.valid[None], k.gd.shape))
        for j in range(sp.E):  # lane q writes its entries of the entry state
            hck[bgi, c, k.d[ti, li], sp.n[j][li]] = h[j][bgi, ti, li]
        parts = []
        for s in range(CHUNK):
            dt, dtu, uv, _ = k.staged(t0 + s)
            bv, cv = k.row(k.B, t0 + s), k.row(k.C, t0 + s)
            p = np.zeros(k.gd.shape, F32)
            for j in range(sp.E):
                h[j] = np.exp2(dt * k.A2[j]) * h[j] + dtu * bv[j]
                p = p + cv[j] * h[j]
            parts.append(p)
        sums = sp.steps_sum(parts)
        for s in range(min(CHUNK, L - t0)):
            # lane q == s % P holds the step's y and writes it with D*u
            uv = k.staged(t0 + s)[2]
            keep = np.broadcast_to(k.valid[None] & (sp.q == s % P), k.gd.shape)
            bgi, ti, li = np.nonzero(keep)
            y[bgi, t0 + s, k.d[ti, li]] = (sums[s // P] + k.Dk * uv)[bgi, ti, li]
    return y.reshape(Bsz, G, L, DG), hck.reshape(Bsz, G, n_chunks, DG, N)


def model_bwd(u, delta, A, B, C, D, bias, softplus, dy, hck, P):
    """The backward kernel's split: the 7 gradients, with dB and dC built
    from the transpose-reduce, the per-warp shared sums and the per-block
    partials, then added up as the wrapper adds them."""
    sp = Split(P)
    assert sp.P == 4 and sp.WC == 8  # transpose_reduce's shape
    Bsz, G, L, DG = u.shape
    k = Blocks(sp, u, delta, A, B, C, D, bias, softplus)
    dyr = dy.reshape(Bsz * G, L, DG)
    hckr = hck.reshape(Bsz * G, -1, DG, N)
    shape = k.gd.shape
    g_next = np.zeros((sp.E,) + shape, F32)
    dA = np.zeros((sp.E,) + shape, F32)
    dD = np.zeros(shape, F32)
    dbias = np.zeros(shape, F32)
    ddelta = np.zeros((Bsz * G, L, DG), F32)
    du = np.zeros((Bsz * G, L, DG), F32)
    n_chunks = -(-L // CHUNK)
    dB_part = np.zeros((k.n_tiles, Bsz * G, L, N), F32)
    dC_part = np.zeros((k.n_tiles, Bsz * G, L, N), F32)
    n_lane = sp.n_of_lane()
    for c in reversed(range(n_chunks)):
        t0 = c * CHUNK
        st = [k.staged(t0 + s) for s in range(CHUNK)]
        dys = [np.where(k.valid[None] & (t0 + s < L), k.chan(dyr, min(t0 + s, L - 1)), F32(0))
               for s in range(CHUNK)]
        for s in range(CHUNK):  # lane q stages, and adds dy u of, the steps s % P == q
            dD = dD + np.where(sp.q == s % P, dys[s] * st[s][2], F32(0))
        h_in = np.stack([hckr[k.bg, c, k.d[None], sp.n[j][None, None]] for j in range(sp.E)])
        hs = []
        h = h_in
        for s in range(CHUNK):
            dt, dtu = st[s][0], st[s][1]
            bv = k.row(k.B, t0 + s)
            h = np.stack([np.exp2(dt * k.A2[j]) * h[j] + dtu * bv[j] for j in range(sp.E)])
            hs.append(h)
        dbc = np.zeros((2, Bsz * G, k.n_tiles, sp.T // 32, CHUNK, N), F32)  # [dB, dC][warp]
        ddu_s, dah_s = [None] * CHUNK, [None] * CHUNK
        for s in reversed(range(CHUNK)):
            dt, dtu = st[s][0], st[s][1]
            bv, cv = k.row(k.B, t0 + s), k.row(k.C, t0 + s)
            h_prev = hs[s - 1] if s > 0 else h_in
            ddu = np.zeros(shape, F32)
            dah = np.zeros(shape, F32)
            vb, vc = [], []
            for j in range(sp.E):
                a = np.exp2(dt * k.A2[j])
                g = cv[j] * dys[s] + g_next[j]
                g_next[j] = a * g
                vb.append(g * dtu)
                vc.append(dys[s] * hs[s][j])
                ddu = ddu + g * bv[j]
                da = g * h_prev[j] * a
                dah = dah + da * k.A2[j]
                dA[j] = dA[j] + da * dt
            ddu_s[s], dah_s[s] = sp.channel_sum(ddu), sp.channel_sum(dah) * LN2
            sb, sc = sp.transpose_reduce(np.stack(vb)), sp.transpose_reduce(np.stack(vc))
            for li in range(16):  # lanes 0..15 of each warp write their n
                for w in range(sp.T // 32):
                    dbc[0, :, :, w, s, n_lane[li]] = sb[:, :, w * 32 + li]
                    dbc[1, :, :, w, s, n_lane[li]] = sc[:, :, w * 32 + li]
        # the block's (step, n) sums over its warps, in warp order
        tot = np.zeros(dbc.shape[:3] + dbc.shape[4:], F32)
        for w in range(sp.T // 32):
            tot = tot + dbc[:, :, :, w]
        for s in range(min(CHUNK, L - t0)):
            dB_part[:, :, t0 + s] = tot[0, :, :, s].transpose(1, 0, 2)
            dC_part[:, :, t0 + s] = tot[1, :, :, s].transpose(1, 0, 2)
        for s in range(min(CHUNK, L - t0)):  # lane q == s % P finishes step s
            dt, _, uv, sig = st[s]
            ddt = (ddu_s[s] * uv + dah_s[s]) * sig
            keep = np.broadcast_to(k.valid[None] & (sp.q == s % P), k.gd.shape)
            bgi, ti, li = np.nonzero(keep)
            ddelta[bgi, t0 + s, k.d[ti, li]] = ddt[bgi, ti, li]
            du[bgi, t0 + s, k.d[ti, li]] = (ddu_s[s] * dt + dys[s] * k.Dk)[bgi, ti, li]
            dbias = dbias + np.where(keep, ddt, F32(0))
    dD, dbias = sp.channel_sum(dD), sp.channel_sum(dbias)
    dA_out = np.zeros((Bsz * G, DG, N), F32)
    dD_out = np.zeros((Bsz * G, DG), F32)
    dbias_out = np.zeros((Bsz * G, DG), F32)
    bgi, ti, li = np.nonzero(np.broadcast_to(k.valid[None], shape))
    for j in range(sp.E):
        dA_out[bgi, k.d[ti, li], sp.n[j][li]] = dA[j][bgi, ti, li]
    first = sp.q[li] == 0
    dD_out[bgi[first], k.d[ti, li][first]] = dD[bgi, ti, li][first]
    dbias_out[bgi[first], k.d[ti, li][first]] = dbias[bgi, ti, li][first]
    r = lambda x: x.reshape(Bsz, G, *x.shape[1:])  # noqa: E731
    return (r(du), r(ddelta), dA_out.reshape(Bsz, G * DG, N).sum(0),
            dB_part.sum(0).reshape(Bsz, G, L, N), dC_part.sum(0).reshape(Bsz, G, L, N),
            dD_out.reshape(Bsz, G * DG).sum(0), dbias_out.reshape(Bsz, G * DG).sum(0)), \
        dB_part


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), want.double().numpy()
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-5, f"{what}: rel err {err:.3e}"


def test_kernel_constants_are_the_models():
    fwd, bwd = _source("selective_scan_fwd.cu"), _source("selective_scan_bwd.cu")
    common = _source("selective_scan_common.cuh")
    assert _p("fwd") == 4 and _p("bwd") == 4
    assert _constant(common, "kChunk") == CHUNK == 16
    assert _constant(common, "kBlockChannels") == BLOCK_CHANNELS == 64
    assert _constant(common, "kN") == N
    assert N_OF_LANE_SRC in bwd and "if (lane < 16)" in bwd
    assert "steps_sum<kP>(yk, q)" in fwd and "q == s % kP" in bwd


@pytest.mark.parametrize("P", [1, 2, 4])
def test_lane_map_covers_each_channel_entry_once(P):
    sp = Split(P)
    pairs = {(int(sp.ch[t]), int(sp.n[j, t])) for t in range(sp.T) for j in range(sp.E)}
    assert len(pairs) == sp.T * sp.E == BLOCK_CHANNELS * N
    # the lanes of a channel are neighbours, and a warp's channels are too
    assert all(sp.ch[t] == (t // P) for t in range(sp.T))
    # each lane's entries are contiguous: 16 / P floats, one or more 16-byte rows
    assert np.all(np.diff(sp.n, axis=0) == 1) and sp.E % 4 == 0


@pytest.mark.parametrize("P", [1, 2, 4])
def test_steps_sum_leaves_each_step_on_the_lane_that_staged_it(P):
    sp = Split(P)
    # lane (channel c, q) holds 1000 * c + 100 * q + s for step s
    parts = [1000.0 * sp.ch + 100.0 * sp.q + s for s in range(CHUNK)]
    sums = sp.steps_sum(parts)
    assert sums.shape == (CHUNK // P, sp.T)
    for k in range(CHUNK // P):
        s = sp.q + P * k
        assert np.array_equal(sums[k], P * (1000.0 * sp.ch + s) + 100.0 * sum(range(P)))


def test_transpose_reduce_leaves_each_n_on_one_lane_of_sixteen():
    sp = Split(4)
    n = sp.n_of_lane()[:32]
    assert sorted(n[:16]) == list(range(16)) and np.array_equal(n[:16], n[16:])
    # each channel's v[j] = 1000 * channel + n: the sum over the 8 channels
    # of a warp lands on the lane that n_of_lane names
    v = np.stack([1000.0 * sp.ch + sp.n[j] for j in range(4)]).astype(np.float64)
    x = sp.transpose_reduce(v)
    for t in range(sp.T):
        w = sp.warp[t]
        want = sum(1000.0 * (w * 8 + c) + n[t % 32] for c in range(8))
        assert x[t] == want
    # a slipped bit (bit2 and bit3 swapped) names the wrong n
    slipped = 4 * sp.q + 2 * ((sp.lane >> 3) & 1) + ((sp.lane >> 2) & 1)
    assert not np.array_equal(slipped, n)


@pytest.mark.parametrize("softplus", [True, False])
def test_forward_split_matches_plain(softplus):
    u, delta, A, B, C, D, bias, _ = _inputs(2, 2, 37, 80, seed=0)
    if not softplus:  # a raw step size is positive
        delta, bias = np.abs(delta), np.zeros_like(bias)
    y, hck = model_fwd(u, delta, A, B, C, D, bias, softplus, _p("fwd"))
    t = [torch.from_numpy(x) for x in (u, delta, A, B, C, D, bias)]
    y_p, hck_p = _scan_tm_plain(*t, softplus, return_hck=True)
    _close(y, y_p, "y")
    _close(hck, hck_p, "hck")


@pytest.mark.parametrize("softplus", [True, False])
def test_backward_split_matches_plain(softplus):
    u, delta, A, B, C, D, bias, dy = _inputs(2, 2, 37, 80, seed=1)
    if not softplus:  # a raw step size is positive
        delta, bias = np.abs(delta), np.zeros_like(bias)
    t = [torch.from_numpy(x) for x in (u, delta, A, B, C, D, bias)]
    _, hck = _scan_tm_plain(*t, softplus, return_hck=True)
    want = _scan_tm_plain_bwd(*t, softplus, torch.from_numpy(dy), hck)
    got, dB_part = model_bwd(u, delta, A, B, C, D, bias, softplus, dy, hck.numpy(),
                             _p("bwd"))
    for name, g, w in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dbias"), got, want):
        _close(g, w, name)
    # ceil(80 / 64) = 2 partials: the first block's 64 channels and the 16 past them
    assert dB_part.shape == (2, 4, 37, N)
    assert np.abs(dB_part[0]).max() > 0 and np.abs(dB_part[1]).max() > 0


def test_b_and_c_reach_the_kernels_16_byte_aligned():
    """The kernels stage B and C by 16-byte copies: ``_aligned`` keeps an
    aligned tensor as it is and copies one whose data starts off a 16-byte
    boundary (a view at an odd offset)."""
    base = torch.arange(65, dtype=torch.float32)
    aligned = base[:64].view(4, N)
    assert _aligned(aligned) is aligned
    view = base[1:].view(4, N)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    copy = _aligned(view)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)
