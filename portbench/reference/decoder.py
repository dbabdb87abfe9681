"""The plain reference of the served decoders (the dense GQA transformer
and the hybrid of parallel attention and Mamba-2 SSD heads), in float32
torch with every contraction an ILM contraction of the configuration's
posit format.

It runs a request as its prompt (the tokens the program prefilled,
padding included) followed by the tokens the program served, all but the
last, and returns the logits at the positions where each served token was
chosen.  The prompt's rows are computed as one prefill computes them:
each projection one contraction over the prompt's rows, attention in the
configuration's flash chunks (``q_chunk``/``kv_chunk``, the largest
divisors of the prompt length), the SSD in its chunks.  The served rows
are computed as decode steps compute them: attention over the cache as
it stores K and V (the paged flash-decode's math over posit-word pages,
or the dense decode's softmax over a bfloat16 cache), the SSM as its
recurrence, each row's projections with its own pre-scale.  Where the program's decode step pre-scales the slots of
one batch together, and its paged kernel orders its sums its own way, the
reference parts from it: that is the gap a sound run reads.

Dataflow as the port's: a bfloat16 residual stream, float32 norms and
contractions, the head tied to the embedding cast to bfloat16.  The
decoder is run a layer at a time over all the requests, so that each
layer's weight planes are built once."""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from . import ilm
from . import posit as P

_NEG = -1e30


def _rmsnorm(g, x, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, -1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * g).to(x.dtype)


def _rope(x, positions, theta: float):
    hd = x.shape[-1]
    half = hd // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32)
                      / half).to(x.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def _divisor(T: int, chunk: int) -> int:
    c = min(chunk, T)
    while T % c:
        c -= 1
    return c


def _log_step_scan(x, dim: int):
    n, step = x.shape[dim], 1
    while step < n:
        shifted = F.pad(x.narrow(dim, 0, n - step).movedim(dim, -1),
                        (step, 0)).movedim(-1, dim)
        x = x + shifted
        step *= 2
    return x


class Request:
    """One request: ``prompt`` the prefilled tokens (int), ``served`` the
    tokens the program returned for it."""

    def __init__(self, prompt, served):
        self.prompt = torch.as_tensor(prompt, dtype=torch.long)
        self.served = torch.as_tensor(served, dtype=torch.long)
        self.T = len(self.prompt)


class Decoder:
    def __init__(self, shapes, fmt: P.Format, cache: str, device,
                 page: int = 16):
        """``cache``: how the served rows read K and V back: "posit" (the
        paged pool's words, ``page`` positions a page, through the paged
        flash-decode) or "bfloat16" (a dense cache, the model's decode
        branch)."""
        self.s = shapes
        self.f = fmt
        self.cache = cache
        self.page = page
        self.dev = device
        self.planes_s = 0.0   # seconds spent building weight planes

    # -- contractions -------------------------------------------------

    def _wplanes(self, w):
        return ilm.planes(w, self.f)

    def _proj(self, x, wp, T: int):
        """Rows [0, T) of ``x`` [R, K] as one contraction, each later row as
        its own; ``wp`` the weight's planes.  Float32 [R, N]."""
        x = x.to(torch.float32)
        parts = []
        if T:
            parts.append(ilm.mm(ilm.planes(x[:T], self.f), wp))
        if x.shape[0] > T:
            parts.append(ilm.mm(ilm.planes(x[T:], self.f, per="lead"), wp))
        return torch.cat(parts, 0) if len(parts) > 1 else parts[0]

    def _dot_lax(self, a, b, per: str = "all"):
        """A batched ILM contraction as the reference engine runs it: a
        [n, M, K], b [n, K, N]; the value plane in its straight-through
        form."""
        return ilm.bmm(ilm.planes(a, self.f, per, ste=True),
                       ilm.planes(b, self.f, per, ste=True))

    # -- attention ----------------------------------------------------

    def _scores(self, q, k):
        """q [1, Tq, KV, g, hd] x k [1, S, KV, hd] -> [1, KV, Tq, g, S]."""
        _, Tq, KV, g, hd = q.shape
        S = k.shape[1]
        a = q.permute(0, 2, 1, 3, 4).reshape(KV, Tq * g, hd)
        b = k.permute(0, 2, 3, 1).reshape(KV, hd, S)
        # one call: the pre-scale over each whole operand
        va = ilm.planes(a, self.f, ste=True)
        vb = ilm.planes(b, self.f, ste=True)
        s = ilm.bmm(va, vb).reshape(1, KV, Tq, g, S)
        return (s * (hd ** -0.5)).to(torch.float32)

    def _values(self, p, v):
        """p [1, KV, Tq, g, S] x v [1, S, KV, hd] -> [1, KV, Tq, g, hd]."""
        _, KV, Tq, g, S = p.shape
        hd = v.shape[-1]
        a = p.reshape(KV, Tq * g, S)
        b = v.permute(0, 2, 1, 3).reshape(KV, S, hd)
        o = ilm.bmm(ilm.planes(a, self.f, ste=True),
                    ilm.planes(b, self.f, ste=True))
        return o.reshape(1, KV, Tq, g, hd)

    @staticmethod
    def _mask(t_idx, s_idx, window):
        m = s_idx[None, :] <= t_idx[:, None]
        if window is not None:
            m = m & (s_idx[None, :] > (t_idx[:, None] - window))
        return m

    def _prefill_attention(self, q, k, v, T, window):
        """The prompt rows: the flash chunks of a prefill over T tokens."""
        s = self.s
        H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
        g = H // KV
        qc, kc = _divisor(T, s.q_chunk), _divisor(T, s.kv_chunk)
        dev = q.device
        neg = torch.tensor(_NEG, device=dev)
        outs = []
        for qi in range(T // qc):
            q_i = q[:, qi * qc:(qi + 1) * qc].reshape(1, qc, KV, g, hd)
            t_idx = torch.arange(qc, device=dev) + qi * qc
            m_run = torch.full((1, KV, qc, g), _NEG, dtype=torch.float32,
                               device=dev)
            l_run = torch.zeros((1, KV, qc, g), dtype=torch.float32,
                                device=dev)
            acc = torch.zeros((1, KV, qc, g, hd), dtype=torch.float32,
                              device=dev)
            for ki in range(T // kc):
                lo, hi = ki * kc, (ki + 1) * kc - 1
                # a block no row of this chunk may see leaves the running
                # sums as they are (its probabilities are 0 or erased by
                # the next block's rescale): skipped
                if lo > qi * qc + qc - 1 or (
                        window is not None and hi <= qi * qc - window):
                    continue
                k_i, v_i = k[:, lo:hi + 1], v[:, lo:hi + 1]
                sc = self._scores(q_i, k_i)
                s_idx = torch.arange(kc, device=dev) + lo
                mask = self._mask(t_idx, s_idx, window)
                sc = torch.where(mask[None, None, :, None, :], sc, neg)
                m_new = torch.maximum(m_run, sc.amax(-1))
                alpha = torch.exp(m_run - m_new)
                pexp = torch.exp(sc - m_new[..., None])
                l_run = l_run * alpha + pexp.sum(-1)
                acc = acc * alpha[..., None] + self._values(pexp, v_i)
                m_run = m_new
            out = acc / torch.clamp(l_run[..., None], min=1e-30)
            outs.append(out.movedim(2, 1).reshape(1, qc, H * hd))
        return torch.cat(outs, 1)

    def _decode_attention(self, q, k, v, T, window):
        """The served rows [T, T') over the cache of every position."""
        if self.cache == "posit":
            return self._paged_decode_attention(q, k, v, T, window)
        f = self.f
        H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
        n, Tp = q.shape[1] - T, q.shape[1]
        dev = q.device
        # each row as its step computes it: the cache up to the row's own
        # position (zeros beyond), its pre-scales its own
        t_idx = torch.arange(n, device=dev) + T
        s_idx = torch.arange(Tp, device=dev)
        seen = self._mask(t_idx, s_idx, None)[:, :, None, None]
        zero = torch.zeros((), device=dev)
        kd = torch.where(seen, k.to(torch.bfloat16).to(torch.float32), zero)
        vd = torch.where(seen, v.to(torch.bfloat16).to(torch.float32), zero)
        qa = ilm.planes(q[0, T:].reshape(n, KV, H // KV, hd), f, "lead",
                        ste=True)
        ka = ilm.planes(kd, f, "lead", ste=True)
        sc = (torch.einsum("nkgd,ntkd->nkgt", qa[0], ka[0])
              - torch.einsum("nkgd,ntkd->nkgt", qa[1], ka[1]))
        sc = (sc * (hd ** -0.5)).to(torch.float32)
        mask = self._mask(t_idx, s_idx, window)
        sc = torch.where(mask[:, None, None, :], sc,
                         torch.tensor(_NEG, device=dev))
        pa = ilm.planes(torch.softmax(sc, dim=-1).to(torch.bfloat16), f,
                        "lead", ste=True)
        va = ilm.planes(vd, f, "lead", ste=True)
        o = (torch.einsum("nkgt,ntkd->nkgd", pa[0], va[0])
             - torch.einsum("nkgt,ntkd->nkgd", pa[1], va[1]))
        return o.reshape(1, n, H * hd)

    def _paged_decode_attention(self, q, k, v, T, window):
        """The served rows as the paged flash-decode reads posit-word
        pages: q pre-scaled, K and V the cache's words (no pre-scale),
        scores from their ILM planes, the pages walked with a running max,
        each page's probabilities taken as words against it (no
        pre-scale), the pages summed with the weights exp(m_j - m_last)."""
        f, page = self.f, self.page
        H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
        G = H // KV
        n, Tp = q.shape[1] - T, q.shape[1]
        dev = q.device
        qs = q[0, T:].reshape(n, KV, G, hd).to(torch.float32)
        sq = ilm.pow2_scale(qs, per="lead")
        qv, qr = P.planes(P.flush(qs) / sq, f)
        kv_, kr = P.planes(k[0], f)
        vv, vr = P.planes(v[0], f)
        s = (torch.einsum("nkgd,tkd->nkgt", qv, kv_)
             - torch.einsum("nkgd,tkd->nkgt", qr, kr))
        s = s * (sq * (hd ** -0.5))
        t_idx = torch.arange(n, device=dev) + T
        mask = self._mask(t_idx, torch.arange(Tp, device=dev), window)
        s = torch.where(mask[:, None, None, :], s,
                        torch.tensor(_NEG, device=dev))
        npg = -(-Tp // page)
        s = F.pad(s, (0, npg * page - Tp), value=_NEG).unflatten(
            -1, (npg, page))
        m = torch.cummax(s.amax(-1), dim=-1).values        # [n,KV,G,npg]
        pexp = torch.exp(s - m[..., None])
        w = torch.exp(m - m[..., -1:])[..., None]
        l_run = (pexp.sum(-1, keepdim=True) * w).sum((-2, -1))
        pv_, pr = P.planes(pexp, f)
        pv_ = (pv_ * w).flatten(-2)[..., :Tp]
        pr = (pr * w).flatten(-2)[..., :Tp]
        o = (torch.einsum("nkgt,tkd->nkgd", pv_, vv)
             - torch.einsum("nkgt,tkd->nkgd", pr, vr))
        out = o / torch.clamp(l_run[..., None], min=1e-30)
        return out.reshape(1, n, H * hd)

    def _attention(self, p, wp, x, T, window):
        s = self.s
        Tp = x.shape[1]
        H, KV, hd = s.n_heads, s.n_kv_heads, s.head_dim
        x2 = x[0]
        q = self._proj(x2, wp["wq"], T).reshape(1, Tp, H, hd)
        k = self._proj(x2, wp["wk"], T).reshape(1, Tp, KV, hd)
        v = self._proj(x2, wp["wv"], T).reshape(1, Tp, KV, hd)
        pos = torch.arange(Tp, dtype=torch.int32, device=x.device)
        q = _rope(q, pos, s.rope_theta)
        k = _rope(k, pos, s.rope_theta)
        out = self._prefill_attention(q, k, v, T, window)
        if Tp > T:
            out = torch.cat([out, self._decode_attention(q, k, v, T, window)],
                            1)
        return self._proj(out[0].to(x.dtype), wp["wo"], T)[None]

    # -- SSM (hybrid) ----------------------------------------------------

    def _ssd_prompt(self, xin, dt, A, Bm, Cm):
        """The chunked SSD over the prompt rows, each chunk's contractions
        with their own pre-scales: y [T, H, P], the final state."""
        Q = min(self.s.ssm_chunk, xin.shape[0])
        T, H, Pd = xin.shape
        N = Bm.shape[-1]
        nc = T // Q
        x, dtq = xin.reshape(nc, Q, H, Pd), dt.reshape(nc, Q, H)
        Bq, Cq = Bm.reshape(nc, Q, N), Cm.reshape(nc, Q, N)
        dev = xin.device
        cum = _log_step_scan(dtq * A, 1)                       # [nc, Q, H]
        causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
        scores = self._dot_lax(Cq, Bq.transpose(1, 2), per="lead")
        ldiff = cum[:, :, None, :] - cum[:, None, :, :]
        ldiff = torch.where(causal[None, :, :, None], ldiff,
                            torch.tensor(-1e30, device=dev))
        M = scores[..., None] * torch.exp(ldiff)              # [nc,Q,Q,H]
        xdt = x * dtq[..., None]
        # y_intra[c, i, h] = M[c, :, :, h] @ xdt[c, :, h]; one call a chunk
        Mv = ilm.planes(M.movedim(-1, 1), self.f, "lead", ste=True)
        Xv = ilm.planes(xdt, self.f, "lead", ste=True)
        a = [t.reshape(nc * H, Q, Q) for t in Mv]
        b = [t.permute(0, 2, 1, 3).reshape(nc * H, Q, Pd) for t in Xv]
        y_intra = ilm.bmm(a, b).reshape(nc, H, Q, Pd).movedim(1, 2)
        decay_out = torch.exp(cum[:, -1:, :] - cum)
        w = xdt * decay_out[..., None]
        S_chunk = self._dot_lax(Bq.transpose(1, 2),
                                w.reshape(nc, Q, H * Pd), per="lead")
        S_chunk = S_chunk.reshape(nc, N, H, Pd).movedim(1, 2)  # [nc,H,N,P]
        S = torch.zeros((H, N, Pd), dtype=torch.float32, device=dev)
        s_in = []
        for c in range(nc):
            s_in.append(S)
            S = S * torch.exp(cum[c, -1, :])[:, None, None] + S_chunk[c]
        S_in = torch.stack(s_in).movedim(1, 2).reshape(nc, N, H * Pd)
        y_inter = self._dot_lax(Cq, S_in, per="lead").reshape(nc, Q, H, Pd)
        y_inter = y_inter * torch.exp(cum)[..., None]
        return (y_intra + y_inter).reshape(T, H, Pd), S

    def _gated_norm(self, y, z, g, eps: float = 1e-6):
        y = y * F.silu(z.to(torch.float32))
        var = torch.mean(y * y, -1, keepdim=True)
        return y * torch.rsqrt(var + eps) * g

    def _ssm(self, p, wp, xin, T):
        """The mixer over the prompt rows (chunked) and then the served
        rows (the recurrence, reading the conv tail as a bfloat16 cache)."""
        s = self.s
        Tp = xin.shape[1]
        di, N, H, Pd, K = (s.d_inner, s.ssm_state, s.n_ssm_heads,
                           s.ssm_head_dim, s.conv_kernel)
        zx = self._proj(xin[0], wp["in_proj"], T)             # [T', dproj]
        z, xBC, dt_raw = zx[:, :di], zx[:, di:2 * di + 2 * N], \
            zx[:, 2 * di + 2 * N:]
        A = -torch.exp(p["A_log"])
        dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
        cw, cb = p["conv_w"], p["conv_b"]
        # prompt: the causal conv, then the chunked SSD
        u = xBC[:T][None]
        pad = F.pad(u, (0, 0, K - 1, 0))
        conv = torch.zeros_like(u)
        for i in range(K):
            conv = conv + pad[:, i:i + T, :] * cw[i]
        conv = F.silu(conv + cb)[0]
        xin_p = conv[:, :di].reshape(T, H, Pd)
        y, S = self._ssd_prompt(xin_p, dt[:T], A, conv[:, di:di + N],
                                conv[:, di + N:])
        y = y + p["D"][None, :, None] * xin_p
        ys = [y.reshape(T, H * Pd)]
        # served rows: the decode recurrence
        tail = xBC[T - (K - 1):T].to(torch.bfloat16)
        for r in range(T, Tp):
            window = torch.cat([tail, xBC[r:r + 1].to(torch.bfloat16)], 0)
            c = torch.einsum("kc,kc->c", window.to(torch.float32), cw) + cb
            c = F.silu(c)
            xr = c[:di].reshape(H, Pd)
            Br, Cr = c[di:di + N], c[di + N:]
            dA = torch.exp(dt[r] * A)
            dBx = dt[r][:, None, None] * Br[None, :, None] * xr[:, None, :]
            S = S * dA[:, None, None] + dBx
            yr = torch.einsum("n,hnp->hp", Cr, S) + p["D"][:, None] * xr
            ys.append(yr.reshape(1, H * Pd))
            tail = window[1:]
        y = torch.cat(ys, 0)
        y = self._gated_norm(y, z, p["norm_g"])
        return self._proj(y.to(xin.dtype), wp["out_proj"], T)[None]

    # -- blocks ----------------------------------------------------------

    def _mlp(self, wp, x, T):
        x2 = x[0]
        h = self._proj(x2, wp["wi"], T)
        gate = self._proj(x2, wp["wg"], T)
        return self._proj(F.silu(gate) * h, wp["w_down"], T)[None]

    def _block(self, p, wp, x, T, window):
        if self.s.family == "hybrid":
            xin = _rmsnorm(p["ln1"]["g"], x)
            ha = self._attention(p["attn"], wp, xin, T, window)
            hs = self._ssm(p["ssm"], wp, xin, T)
            h = 0.5 * (_rmsnorm(p["bn_a"]["g"], ha)
                       + _rmsnorm(p["bn_s"]["g"], hs))
            x = x + h.to(x.dtype)
        else:
            h = self._attention(p["attn"], wp, _rmsnorm(p["ln1"]["g"], x), T,
                                window)
            x = x + h.to(x.dtype)
        return x + self._mlp(wp, _rmsnorm(p["ln2"]["g"], x), T).to(x.dtype)

    def _layer_planes(self, p):
        t0 = time.perf_counter()
        out = self._layer_planes_of(p)
        if self.dev != "cpu" and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.planes_s += time.perf_counter() - t0
        return out

    def _layer_planes_of(self, p):
        a, m = p["attn"], p["mlp"]
        out = {k: self._wplanes(a[k]["w"]) for k in ("wq", "wk", "wv", "wo")}
        out.update(wi=self._wplanes(m["wi"]["w"]),
                   wg=self._wplanes(m["wg"]["w"]),
                   w_down=self._wplanes(m["wo"]["w"]))
        if self.s.family == "hybrid":
            out["in_proj"] = self._wplanes(p["ssm"]["in_proj"]["w"])
            out["out_proj"] = self._wplanes(p["ssm"]["out_proj"]["w"])
        return out

    @torch.no_grad()
    def logits(self, params, requests: list[Request]):
        """Per request, float32 logits [n, vocab_padded] at the positions
        where its served tokens were chosen (padded ids at -1e30)."""
        s, dev = self.s, self.dev
        e = params["embed"]["e"]
        xs = []
        for r in requests:
            ids = torch.cat([r.prompt, r.served[:-1]]).to(dev)
            xs.append(torch.index_select(e, 0, ids).to(torch.bfloat16)[None])
        for i, p in enumerate(params["layers"]):
            wp = self._layer_planes(p)
            xs = [self._block(p, wp, x, r.T, s.window_of(i))
                  for x, r in zip(xs, requests)]
            del wp
        head = self._wplanes(e.to(torch.bfloat16).to(torch.float32).t())
        out = []
        for x, r in zip(xs, requests):
            h = _rmsnorm(params["ln_f"]["g"], x)[0, r.T - 1:]
            lg = ilm.mm(ilm.planes(h.to(torch.float32), self.f, per="lead"),
                        head)
            vocab = torch.arange(lg.shape[-1], device=dev)
            out.append(torch.where(vocab >= s.vocab,
                                   torch.tensor(_NEG, device=dev), lg))
        return out


def gaps(logits, served):
    """The gap of each served token: how far its logit lies below the
    best logit at its position (float64, on the host)."""
    best = logits.amax(-1)
    got = logits.gather(-1, served.to(logits.device)[:, None])[:, 0]
    return (best - got).double().cpu()

