"""State-space and recurrent blocks, port of ``repro/nn/ssm.py``: Mamba
(Jamba's SSM layer) and the two xLSTM cells, the mLSTM (matrix memory,
chunkwise-parallel for training and prefill, recurrent for decode) and
the sLSTM (scalar memory, a strict time recurrence).

Plain torch, as the reference is plain JAX (no Pallas kernel). The
reference's ``lax.scan`` loops are Python loops here, in the same time
order and with the same float32 arithmetic: Mamba's selective scan steps
``h = dA_t * h + dBx_t`` one position at a time (not a parallel
associative scan, which would round differently), the mLSTM carries its
(C, n) state from chunk to chunk, the sLSTM steps its cell. Each loop
collects its outputs with ``torch.stack``, so that one code path serves
the prefill and the FedPT client step under ``torch.func.vmap`` /
``grad`` (an in-place write of a batched value into an unbatched buffer
fails under ``vmap``).

Mamba's discretised inputs dA and dBx are made a time chunk at a time
(``MAMBA_CHUNK`` positions) inside the loop, where the reference makes
them whole at (B, S, d_inner, n): 17.2 GB each for Jamba's 1 x 32,768
prefill. They are elementwise, so the bits are the same.

Under tensor parallelism on "model" (``launch/mesh.tensor_parallel``, the
train step and prefill of ``launch/specs`` on a mesh) the blocks take the
reference's placements (``launch/sharding``'s rules): Mamba runs on the
rank's channels, the mLSTM's ``up_proj`` is column-parallel and its
``down_proj`` row-parallel around a replicated cell; the sLSTM, which no
rule splits, runs whole on every rank. One body serves both: without a
group each collective returns its input and a rank's channels are all of
them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import basic

# time positions of Mamba's dA / dBx made at once: (B, 256, d_inner, n)
# float32, 128 MiB each at Jamba's d_inner of 8,192
MAMBA_CHUNK = 256


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (shared by Mamba and the xLSTM blocks)


def causal_conv1d(x, w, b=None):
    """x: (B, S, C), w: (K, C) depthwise kernel -> (B, S, C): a
    cross-correlation over a left pad of K - 1, as the reference's
    ``conv_general_dilated`` with ``feature_group_count=C``."""
    K, C = w.shape
    y = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)), w.t()[:, None, :],
                 groups=C).transpose(1, 2)
    if b is not None:
        y = y + b
    return y


def conv1d_step(x_t, conv_state, w, b=None):
    """Single decode step. x_t: (B, C); conv_state: (B, K-1, C). Returns
    (y (B, C), the new conv state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window, w)
    if b is not None:
        y = y + b
    return y, window[:, 1:, :]


# ---------------------------------------------------------------------------
# Mamba (selective SSM), as used by Jamba [arXiv:2403.19887]


def mamba_dims(cfg: ModelConfig):
    d_inner = cfg.mamba_expand * cfg.d_model
    dt_rank = math.ceil(cfg.d_model / 16)
    return d_inner, dt_rank


def _fma(a, b, c):
    """float32 a * b + c rounded once (the float64 product of two float32
    values is exact)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def log_f32(x) -> np.ndarray:
    """XLA's float32 ``log`` on the host: the Cephes polynomial that Eigen
    evaluates, with fused multiply-adds. ``torch.log`` and a correctly
    rounded log differ from it (log 7 is one ulp apart); this one gives
    ``jnp.log``'s bits at every integer 1..4,096, the arguments of Mamba's
    ``A_log`` init."""
    f = np.float32
    m, e = np.frexp(np.asarray(x, f))
    m, e = m.astype(f), e.astype(f)
    below = m < f(0.707106781186547524)
    e = e - np.where(below, f(1), f(0))
    m = (m - f(1)) + np.where(below, m, f(0))
    x2 = m * m
    x3 = x2 * m
    p = [f(c) for c in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                        -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                        2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]
    y = _fma(_fma(p[0], m, p[1]), m, p[2])
    y1 = _fma(_fma(p[3], m, p[4]), m, p[5])
    y2 = _fma(_fma(p[6], m, p[7]), m, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2) * x3
    y = _fma(f(-2.12194440e-4), e, y)
    m = (m - x2 * f(0.5)) + y
    return _fma(f(0.693359375), e, m)


def init_mamba(seed, path, cfg: ModelConfig, dtype, device=None):
    d = cfg.d_model
    d_inner, dt_rank = mamba_dims(cfg)
    n = cfg.mamba_d_state
    K = cfg.mamba_d_conv
    dev = resolve_device(device)
    # A_log: log(1..n) broadcast over d_inner (S4D-real), not drawn
    a_log = torch.from_numpy(log_f32(np.arange(1, n + 1)))
    return {
        "in_proj": basic.init_dense(seed, f"{path}/in_proj", d, 2 * d_inner,
                                    dtype, device=dev),
        "conv_w": basic.normal_init(seed, f"{path}/conv_w", (K, d_inner),
                                    dtype, fan_in=K, device=dev),
        "conv_b": basic.zeros_init(seed, f"{path}/conv_b", (d_inner,), dtype,
                                   dev),
        "x_proj": basic.init_dense(seed, f"{path}/x_proj", d_inner,
                                   dt_rank + 2 * n, dtype, device=dev),
        "dt_proj": basic.init_dense(seed, f"{path}/dt_proj", dt_rank, d_inner,
                                    dtype, bias=True, device=dev),
        "A_log": a_log.expand(d_inner, n).to(dev, dtype).contiguous(),
        "D": basic.ones_init(seed, f"{path}/D", (d_inner,), dtype, dev),
        "out_proj": basic.init_dense(seed, f"{path}/out_proj", d_inner, d,
                                     dtype, device=dev),
    }


def _mamba_scan(dt, xs, Bm, Cm, A, h):
    """The selective scan in float32, in time order: h = dA_t * h + dBx_t
    (one ``addcmul`` a position), y_t = h . C_t, with dA = exp(dt A) and
    dBx = (dt x) B made ``MAMBA_CHUNK`` positions at a time. Returns (y
    (B, S, d_inner) float32, the final h)."""
    S = dt.shape[1]
    dtx = (dt * xs).float()
    ys = []
    for a in range(0, S, MAMBA_CHUNK):
        b = min(a + MAMBA_CHUNK, S)
        dA = torch.exp(dt[:, a:b].float()[..., None] * A)   # (B, L, di, n)
        dBx = dtx[:, a:b, :, None] * Bm[:, a:b, None, :].float()
        hs = []
        for t in range(b - a):
            h = torch.addcmul(dBx[:, t], dA[:, t], h)
            hs.append(h)
        ys.append(torch.einsum("bldn,bln->bld", torch.stack(hs, dim=1),
                               Cm[:, a:b].float()))
    return torch.cat(ys, dim=1), h


def _rank_cols(t, width: int, whole: int, what: str):
    """This rank's ``width`` of the ``whole`` last-dim columns of a
    replicated ``t``, entering rank-local work through ``tp_copy`` (so
    that its gradient sums over the ranks); all of them without a
    tensor-parallel group."""
    tp = mesh_lib.current_tp()
    size, rank = (1, 0) if tp is None else (tp.size, tp.rank)
    if width * size != whole:
        raise NotImplementedError(f"{what} {whole} split unevenly on {size} "
                                  f"'model' ranks")
    return mesh_lib.tp_copy(t)[..., rank * width:(rank + 1) * width]


def mamba_forward(x, p, cfg: ModelConfig, h0=None):
    """x: (B, S, d) -> (B, S, d); returns (out, (h_final, conv_tail)),
    conv_tail the last K - 1 positions of the pre-conv ``xs`` for decode
    to continue from.

    Under a tensor-parallel group, with the leaves placed by
    ``launch/sharding``'s rules, the block runs on the rank's d_inner / M
    channels: ``in_proj`` column-parallel, its column block moved to the
    rank's channels of xs and z (``launch/mesh.tp_channels``); ``conv_w``,
    ``conv_b``, ``A_log``, ``D`` and ``dt_proj``'s kernel the rank's
    channels; ``x_proj`` row-parallel (dt, B and C summed over the ranks,
    then entering rank-local work through ``tp_copy``); ``dt_proj``'s
    bias, which no rule splits, read at the rank's channels; the float32
    scan on the rank's channels; ``out_proj`` row-parallel. The state
    returned is then the rank's channels."""
    d_inner, dt_rank = mamba_dims(cfg)
    n = cfg.mamba_d_state
    cd = cfg.cdtype
    dl = p["D"].shape[-1]                       # this rank's channels
    cols = basic.dense(mesh_lib.tp_copy(x), p["in_proj"], cd)
    xs_pre, z = mesh_lib.tp_channels(cols).chunk(2, dim=-1)
    xs = F.silu(causal_conv1d(xs_pre, p["conv_w"].to(cd),
                              p["conv_b"].to(cd)))
    dbc = mesh_lib.tp_reduce(basic.dense(xs, p["x_proj"], cd))
    dt, Bm, Cm = mesh_lib.tp_copy(dbc).split([dt_rank, n, n], dim=-1)
    dtp = p["dt_proj"]
    bias = _rank_cols(dtp["bias"], dl, d_inner, "Mamba's d_inner")
    dt = F.softplus(basic.dense(dt, {"kernel": dtp["kernel"], "bias": bias},
                                cd))                       # (B, S, dl)
    A = -torch.exp(p["A_log"].float())                     # (dl, n)
    h = torch.zeros((x.shape[0], dl, n), dtype=torch.float32,
                    device=x.device) if h0 is None else h0
    y, h_fin = _mamba_scan(dt, xs, Bm, Cm, A, h)
    y = y.to(cd) + xs * p["D"].to(cd)
    y = y * F.silu(z)
    out = basic.row_parallel(y, p["out_proj"], cd)
    return out, (h_fin, xs_pre[:, -(cfg.mamba_d_conv - 1):, :])


def mamba_step(x_t, p, cfg: ModelConfig, state):
    """Decode step. x_t: (B, d); state = (h (B, di, n), conv (B, K-1, di))."""
    h, conv_state = state
    _, dt_rank = mamba_dims(cfg)
    n = cfg.mamba_d_state
    cd = cfg.cdtype
    xs, z = basic.dense(x_t, p["in_proj"], cd).chunk(2, dim=-1)
    xc, conv_state = conv1d_step(xs, conv_state, p["conv_w"].to(cd),
                                 p["conv_b"].to(cd))
    xc = F.silu(xc)
    dt, Bm, Cm = basic.dense(xc, p["x_proj"], cd).split([dt_rank, n, n],
                                                        dim=-1)
    dt = F.softplus(basic.dense(dt, p["dt_proj"], cd)).float()
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * xc.float())[..., None] * Bm.float()[:, None, :]
    h = torch.addcmul(dBx, dA, h)
    y = torch.einsum("bdn,bn->bd", h, Cm.float()).to(cd)
    y = y + xc * p["D"].to(cd)
    y = y * F.silu(z)
    return basic.dense(y, p["out_proj"], cd), (h, conv_state)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM, arXiv:2405.04517): matrix memory with exponential gating,
# chunkwise-parallel; per-head state (C: dh x dh, n: dh)


def xlstm_dims(cfg: ModelConfig):
    d_in = int(cfg.xlstm_proj_factor * cfg.d_model)
    nh = cfg.num_heads
    return d_in, nh, d_in // nh


def init_mlstm(seed, path, cfg: ModelConfig, dtype, device=None):
    d = cfg.d_model
    d_in, nh, _ = xlstm_dims(cfg)
    K = 4

    def dense(name, d_out, d_inp=d_in, bias=True):
        return basic.init_dense(seed, f"{path}/{name}", d_inp, d_out, dtype,
                                bias=bias, device=device)
    return {
        "up_proj": dense("up_proj", 2 * d_in, d, bias=False),
        "conv_w": basic.normal_init(seed, f"{path}/conv_w", (K, d_in), dtype,
                                    fan_in=K, device=device),
        "conv_b": basic.zeros_init(seed, f"{path}/conv_b", (d_in,), dtype,
                                   device),
        "wq": dense("wq", d_in),
        "wk": dense("wk", d_in),
        "wv": dense("wv", d_in),
        "w_if": dense("w_if", 2 * nh),
        "ogate_norm": basic.init_norm(seed, f"{path}/ogate_norm", d_in, dtype,
                                      "rmsnorm", device),
        "down_proj": dense("down_proj", d, bias=False),
    }


def _sqrt_dh(dh: int, cd, device):
    """sqrt(dh) taken in the compute dtype, as the reference's
    ``jnp.sqrt(jnp.asarray(dh, cd))``: 22.625 in bf16 at dh = 512, not
    22.627. A tensor on the operand's device, so that the division is a
    true division (torch's CUDA division by a Python scalar multiplies by
    its reciprocal)."""
    return torch.sqrt(torch.tensor(dh, dtype=cd, device=device))


def _mlstm_qkvif(x, p, cfg: ModelConfig):
    """q, k, v, the log gates and z from the block's input ``x``; under a
    tensor-parallel group ``up_proj`` is column-parallel and its output
    joined over "model"."""
    d_in, nh, dh = xlstm_dims(cfg)
    cd = cfg.cdtype
    B, S, _ = x.shape
    xm, z = mesh_lib.tp_gather(basic.dense(mesh_lib.tp_copy(x),
                                           p["up_proj"], cd), -1).chunk(
        2, dim=-1)
    xc = F.silu(causal_conv1d(xm, p["conv_w"].to(cd), p["conv_b"].to(cd)))

    def heads(t):
        return t.reshape(B, S, nh, dh).transpose(1, 2)
    q = heads(basic.dense(xc, p["wq"], cd))
    k = heads(basic.dense(xc, p["wk"], cd))
    v = heads(basic.dense(xm, p["wv"], cd))
    log_i, f_pre = basic.dense(xc, p["w_if"], torch.float32).chunk(2, dim=-1)
    log_i = log_i.transpose(1, 2)                              # (B, nh, S)
    log_f = F.logsigmoid(f_pre).transpose(1, 2)
    k = k / _sqrt_dh(dh, cd, k.device)
    return q, k, v, log_i, log_f, z


def _mlstm_chunk(q, k, v, li, lf, C, n):
    """One chunk of the chunkwise mLSTM in float32: q, k, v (B, nh, L,
    dh), log gates (B, nh, L), the state (C, n) at the chunk's start.
    Returns (h (B, nh, L, dh), C, n at its end)."""
    L = q.shape[-2]
    q, k, v = q.float(), k.float(), v.float()
    Fc = torch.cumsum(lf, dim=-1)                               # (B, nh, L)
    # decay matrix D_ts = exp(F_t - F_s + li_s), s <= t
    Dlog = Fc[..., :, None] - Fc[..., None, :] + li[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    # the exp of the masked log-decay, where the reference masks the exp
    # (the same values): above the diagonal F_t - F_s + li_s passes
    # float32's exp range once the forget gates close (xLSTM-350M's FedPT
    # steps get there at full width), and the gradient of where(tri,
    # exp(Dlog), 0) there is 0 * inf = NaN
    D = torch.exp(torch.where(tri, Dlog, -math.inf))
    S_ = (q @ k.transpose(-1, -2)) * D
    eF = torch.exp(Fc)
    num = S_ @ v + eF[..., None] * (q @ C)
    den = S_.sum(-1) + eF * (q @ n[..., None])[..., 0]
    h = num / torch.clamp_min(den.abs(), 1.0)[..., None]
    # the state at the chunk's end
    decay_all = torch.exp(Fc[..., -1:] - Fc + li)               # (B, nh, L)
    eL = torch.exp(Fc[..., -1])
    dk = decay_all[..., None] * k
    C = eL[..., None, None] * C + dk.transpose(-1, -2) @ v
    n = eL[..., None] * n + dk.sum(-2)
    return h, C, n


def mlstm_forward(x, p, cfg: ModelConfig, state=None, chunk: int = 128):
    """x: (B, S, d) -> (B, S, d). Chunkwise-parallel mLSTM with no
    max-stabiliser (as the reference); the sequence is padded to whole
    chunks with log_i = -30 and log_f = 0. Returns (out, (C, n)) at the
    sequence's end (no conv state, as the reference returns).

    Under a tensor-parallel group, with the leaves placed by
    ``launch/sharding``'s rules: ``up_proj`` column-parallel, its output
    joined over "model"; the cell (``conv``, ``wq`` / ``wk`` / ``wv``,
    ``w_if``, ``ogate_norm``), which the rules replicate, whole on every
    rank; ``down_proj`` row-parallel on the rank's rows of h * silu(z)."""
    B, S, _ = x.shape
    d_in, nh, dh = xlstm_dims(cfg)
    cd = cfg.cdtype
    q, k, v, log_i, log_f, z = _mlstm_qkvif(x, p, cfg)
    nchunks = max(1, -(-S // chunk))
    pad = nchunks * chunk - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, pad), value=-30.0)
        log_f = F.pad(log_f, (0, pad))
    if state is None:
        C = torch.zeros((B, nh, dh, dh), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, nh, dh), dtype=torch.float32, device=x.device)
    else:
        C, n = state
    hs = []
    for c in range(nchunks):
        s = slice(c * chunk, (c + 1) * chunk)
        h, C, n = _mlstm_chunk(q[:, :, s], k[:, :, s], v[:, :, s],
                               log_i[..., s], log_f[..., s], C, n)
        hs.append(h.to(cd))
    h = torch.cat(hs, dim=2)[:, :, :S]                      # (B, nh, S, dh)
    h = h.transpose(1, 2).reshape(B, S, d_in)
    h = basic.rmsnorm(h, p["ogate_norm"]["scale"])
    h = _rank_cols(h * F.silu(z), p["down_proj"]["kernel"].shape[-2], d_in,
                   "the mLSTM's d_in")
    return basic.row_parallel(h, p["down_proj"], cd), (C, n)


def mlstm_step(x_t, p, cfg: ModelConfig, state):
    """Decode step. state = (C (B, nh, dh, dh), n (B, nh, dh), conv (B, 3,
    d_in))."""
    C, n, conv_state = state
    d_in, nh, dh = xlstm_dims(cfg)
    cd = cfg.cdtype
    B = x_t.shape[0]
    xm, z = basic.dense(x_t, p["up_proj"], cd).chunk(2, dim=-1)
    xc, conv_state = conv1d_step(xm, conv_state, p["conv_w"].to(cd),
                                 p["conv_b"].to(cd))
    xc = F.silu(xc)
    q = basic.dense(xc, p["wq"], cd).reshape(B, nh, dh).float()
    k = basic.dense(xc, p["wk"], cd).reshape(B, nh, dh)
    k = (k / _sqrt_dh(dh, cd, k.device)).float()
    v = basic.dense(xm, p["wv"], cd).reshape(B, nh, dh).float()
    log_i, f_pre = basic.dense(xc, p["w_if"], torch.float32).chunk(2, dim=-1)
    i = torch.exp(log_i)                                        # (B, nh)
    f = torch.sigmoid(f_pre)
    C = f[..., None, None] * C + i[..., None, None] * (k[..., :, None]
                                                       * v[..., None, :])
    n = f[..., None] * n + i[..., None] * k
    num = (q[..., None, :] @ C)[..., 0, :]
    den = (q * n).sum(-1)
    h = (num / torch.clamp_min(den.abs(), 1.0)[..., None]).to(cd)
    h = basic.rmsnorm(h.reshape(B, d_in), p["ogate_norm"]["scale"])
    h = h * F.silu(z)
    return basic.dense(h, p["down_proj"], cd), (C, n, conv_state)


# ---------------------------------------------------------------------------
# sLSTM: scalar memory, exponential gating, per-head recurrence


def slstm_up_width(d: int) -> int:
    """The gated FFN's width after the cell: int(4 d / 3) rounded down to
    an even number (1,364 at d = 1,024)."""
    return int(4 * d / 3) // 2 * 2


def init_slstm(seed, path, cfg: ModelConfig, dtype, device=None):
    d = cfg.d_model
    nh = cfg.num_heads
    dh = d // nh
    K = 4
    up = slstm_up_width(d)
    return {
        "conv_w": basic.normal_init(seed, f"{path}/conv_w", (K, d), dtype,
                                    fan_in=K, device=device),
        "conv_b": basic.zeros_init(seed, f"{path}/conv_b", (d,), dtype,
                                   device),
        "w_gates": basic.init_dense(seed, f"{path}/w_gates", d, 4 * d, dtype,
                                    bias=True, device=device),
        # block-diagonal recurrent weights per head: (nh, dh, 4*dh)
        "r_gates": basic.normal_init(seed, f"{path}/r_gates", (nh, dh, 4 * dh),
                                     dtype, fan_in=dh, device=device),
        "out_norm": basic.init_norm(seed, f"{path}/out_norm", d, dtype,
                                    "rmsnorm", device),
        "up_gate": basic.init_dense(seed, f"{path}/up_gate", d, up, dtype,
                                    device=device),
        "up_proj": basic.init_dense(seed, f"{path}/up_proj", d, up, dtype,
                                    device=device),
        "down_proj": basic.init_dense(seed, f"{path}/down_proj", up, d, dtype,
                                      device=device),
    }


def _slstm_cell(w_t, r_gates, state, nh, dh):
    """w_t: (B, 4*d) float32 input pre-activations; r_gates (nh, dh,
    4*dh) float32; state = (c, n, h, m) each (B, nh, dh). Each head's 4*dh
    gate pre-activations are z, i, f, o in turn. Returns (state, h)."""
    c, n, h, m = state
    B = w_t.shape[0]
    rec = torch.einsum("bhd,hdg->bhg", h, r_gates)
    pre = w_t.reshape(B, nh, 4 * dh) + rec
    z_pre, i_pre, f_pre, o_pre = pre.split(dh, dim=-1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    log_f_m = F.logsigmoid(f_pre) + m
    m_new = torch.maximum(log_f_m, i_pre)
    i = torch.exp(i_pre - m_new)
    f = torch.exp(log_f_m - m_new)
    c = f * c + i * z
    n = f * n + i
    h_new = o * c / torch.clamp_min(n, 1.0)
    return (c, n, h_new, m_new), h_new


def _slstm_scan(w, r_gates, state, nh, dh):
    """The sLSTM cell over time: w (B, S, 4*d) float32. Returns (h (B, S,
    nh, dh) float32, the final state)."""
    hs = []
    for t in range(w.shape[1]):
        state, h = _slstm_cell(w[:, t], r_gates, state, nh, dh)
        hs.append(h)
    return torch.stack(hs, dim=1), state


def _slstm_out(h, p, cfg: ModelConfig):
    """The post-up-projection block after the cell: rmsnorm, then a gated
    FFN of width ``slstm_up_width``."""
    cd = cfg.cdtype
    h = basic.rmsnorm(h, p["out_norm"]["scale"])
    u = F.silu(basic.dense(h, p["up_gate"], cd)) * basic.dense(
        h, p["up_proj"], cd)
    return basic.dense(u, p["down_proj"], cd)


def slstm_forward(x, p, cfg: ModelConfig, state=None):
    """x: (B, S, d) -> (B, S, d). Strict time recurrence; the state (c, n,
    h, m) starts at zeros with m = -30. Returns (out, state)."""
    B, S, d = x.shape
    nh = cfg.num_heads
    dh = d // nh
    cd = cfg.cdtype
    xc = F.silu(causal_conv1d(x.to(cd), p["conv_w"].to(cd),
                              p["conv_b"].to(cd)))
    w = basic.dense(xc, p["w_gates"], cd)                       # (B, S, 4d)
    if state is None:
        zeros = torch.zeros((B, nh, dh), dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros, zeros - 30.0)
    hs, state = _slstm_scan(w.float(), p["r_gates"].float(), state, nh, dh)
    return _slstm_out(hs.reshape(B, S, d).to(cd), p, cfg), state


def slstm_step(x_t, p, cfg: ModelConfig, state):
    """Decode step. state = (cell state (c, n, h, m), conv state (B, 3,
    d))."""
    cell, conv_state = state
    cd = cfg.cdtype
    B, d = x_t.shape
    nh = cfg.num_heads
    xc, conv_state = conv1d_step(x_t.to(cd), conv_state, p["conv_w"].to(cd),
                                 p["conv_b"].to(cd))
    w = basic.dense(F.silu(xc), p["w_gates"], cd)
    cell, h = _slstm_cell(w.float(), p["r_gates"].float(), cell, nh, d // nh)
    return _slstm_out(h.reshape(B, d).to(cd), p, cfg), (cell, conv_state)
