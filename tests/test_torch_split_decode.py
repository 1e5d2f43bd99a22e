"""Kernel K3's split over the sequence and its merge, mirrored in plain
PyTorch on the CPU.

The CUDA kernel (``u2tokenizer_torch/csrc/decode_attention.cu``) cuts the
visible cache rows of each (row, kv head) into ``split_count`` shares
(``_split_rows``), runs an online softmax over each share and merges the
shares' (max, sum, value sums) in split order. ``_split_mirror`` does the
same arithmetic with the same shares and the same merge, and takes a row
with fewer than ``EXACT_ROWS`` visible rows through the plain version, as
the kernel does. It is held against the plain version
``decode_attention_reference`` and against the Pallas ``_decode_kernel``
in interpret mode, for int8 and packed int4 caches. Inputs come from
numpy seeds.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2tokenizer_torch.ops import attention as t_attn
from u2tokenizer_torch.ops import decode_attention as t_dec
from u2tokenizer_tpu.ops import attention as j_attn
from u2tokenizer_tpu.ops import decode_attention as j_dec

pytestmark = pytest.mark.fast

B, H, HKV, D, S_PROMPT, S_TOTAL = 3, 4, 2, 16, 16, 24


def _split_rows(prompt_len, end, s_prompt: int, sk: int, n_split: int):
    """(B, n_split) first and one-past-last visible row of each split, as
    the kernel computes them from prompt_len and end: the visible rows
    [0, a) + [c, e) renumbered 0 .. n_vis-1 and cut into shares of
    ceil(n_vis / n_split)."""
    a = prompt_len.clamp(0, sk)
    c = torch.clamp(torch.full_like(a, s_prompt), min=a)
    e = torch.maximum(end.clamp(max=sk), c)
    n_vis = (a + (e - c)).long()[:, None]
    share = (n_vis + n_split - 1) // n_split
    lo = torch.minimum(torch.arange(n_split, device=a.device) * share, n_vis)
    return lo, torch.minimum(lo + share, n_vis)




def _split_mirror(q, k_int, k_scale, v_int, v_scale, prompt_len, end,
                  s_prompt, n_split, scale=None,
                  exact_rows=t_dec.EXACT_ROWS):
    """K3 as the kernel computes it: per split the max m, the sum l of
    exp(s - m) and the value sums of p = q.dtype(exp(s - m) * v_scale);
    then the splits merged in order, out = sum o e^(m - M) / sum l
    e^(m - M) in q's dtype. A batch row with fewer than ``exact_rows``
    visible rows takes the plain version, as the kernel does."""
    b, _, h, d = q.shape
    if scale is None:
        scale = 1.0 / d ** 0.5
    if k_int.shape[-1] != d:
        k_int, v_int = t_attn.unpack_nibbles(k_int), t_attn.unpack_nibbles(
            v_int)
    hkv, sk = k_int.shape[1], k_int.shape[2]
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float().reshape(
        b, hkv, h // hkv, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qs, k_int.float())
    s = s * k_scale.float()[:, :, None, :]
    # each slot's place in the renumbered visible rows [0, a) + [c, e)
    a = prompt_len.clamp(0, sk).long()[:, None]
    c = torch.clamp(torch.full_like(a, s_prompt), min=a)
    e = torch.maximum(end.clamp(max=sk).long()[:, None], c)
    j = torch.arange(sk)[None, :]
    idx = torch.where(j < a, j, torch.where((j >= c) & (j < e), j - c + a,
                                            torch.full_like(j, -1)))
    lo, hi = _split_rows(prompt_len, end, s_prompt, sk, n_split)
    parts = []
    for sp in range(n_split):
        member = (idx >= lo[:, sp:sp + 1]) & (idx < hi[:, sp:sp + 1])
        member = member[:, None, None, :]
        m = s.masked_fill(~member, -math.inf).amax(-1, keepdim=True)
        p = torch.where(member, torch.exp(s - m), torch.zeros_like(s))
        pv = (p * v_scale.float()[:, :, None, :]).to(q.dtype).float()
        o = torch.einsum("bhgk,bhkd->bhgd", pv, v_int.float())
        parts.append((m, p.sum(-1, keepdim=True), o))
    big_m = torch.stack([m for m, _, _ in parts]).amax(0)
    big_l = torch.zeros_like(big_m)
    acc = torch.zeros_like(parts[0][2])
    for m, l, o in parts:  # in split order
        f = torch.where(m == -math.inf, torch.zeros_like(m),
                        torch.exp(m - big_m))
        big_l = big_l + l * f
        acc = acc + o * f
    out = torch.where(big_l > 0, acc / big_l, torch.zeros_like(acc))
    out = out.to(q.dtype).reshape(b, 1, h, d)
    short = (hi[:, -1] < exact_rows)[:, None, None, None]
    ref = t_dec.decode_attention_reference(q, k_int, k_scale, v_int, v_scale,
                                           prompt_len, end, s_prompt, scale)
    return torch.where(short, ref, out)


def _inputs(bits, plen, end, q_dtype=torch.bfloat16, seed=0, d=D,
            s_total=S_TOTAL):
    """JAX's and the port's operands of one decode step: q exact in bf16,
    the cache quantized by the JAX package (int8, or int4 packed for the
    port)."""
    rs = np.random.RandomState(seed)
    b = len(plen)
    q = torch.from_numpy(rs.randn(b, 1, H, d).astype(np.float32)).bfloat16()
    dtype = jnp.int8 if bits == 8 else jnp.int4
    kq, ks = j_attn.quantize_kv(jnp.asarray(
        rs.randn(b, s_total, HKV, d).astype(np.float32)), dtype=dtype)
    vq, vs = j_attn.quantize_kv(jnp.asarray(
        rs.randn(b, s_total, HKV, d).astype(np.float32)), dtype=dtype)
    hm = lambda x: jnp.transpose(x, (0, 2, 1, 3))
    sc = lambda x: np.ascontiguousarray(
        np.asarray(x.astype(jnp.float32))[..., 0].transpose(0, 2, 1))
    plen, end = np.array(plen, np.int32), np.array(end, np.int32)
    jax_args = (jnp.asarray(q.float().numpy()), hm(kq), jnp.asarray(sc(ks)),
                hm(vq), jnp.asarray(sc(vs)), jnp.asarray(plen),
                jnp.asarray(end))
    cache = lambda x: torch.from_numpy(np.ascontiguousarray(
        np.asarray(hm(x)).astype(np.int8)))
    kt, vt = cache(kq), cache(vq)
    if bits == 4:
        kt, vt = t_attn.pack_nibbles(kt), t_attn.pack_nibbles(vt)
    t = torch.from_numpy
    torch_args = (q.to(q_dtype), kt, t(sc(ks)).bfloat16(), vt,
                  t(sc(vs)).bfloat16(), t(plen), t(end))
    return jax_args, torch_args


# (prompt_len, end) of the 3 rows: a mid-run step with a ragged row (a
# prompt of 11 of 16) and a row whose 2-token prompt leaves splits empty;
# decode step 0 (end = s_prompt + 1); the cache's last step
STEPS = {"mid-run, ragged": ([16, 11, 2], [20, 20, 20]),
         "step 0": ([16, 11, 2], [17, 17, 17]),
         "last step": ([16, 9, 1], [24, 24, 24])}
K3_TOL = dict(atol=1e-3, rtol=1e-2)  # chip_smoke.py's TOL for K3


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("step", list(STEPS))
@pytest.mark.parametrize("n_split", [1, 3, 7, 40])
def test_split_merge_matches_plain(bits, step, n_split):
    """In fp32 (no rounding of p) the split and merge, taken at every row
    however short, give the plain version's output to fp32 summation
    order at every split count (n_split 1 is the unsplit kernel). In bf16
    these rows are all short of EXACT_ROWS, so the kernel takes them in
    the plain version's order of rounding: its output is the plain one."""
    plen, end = STEPS[step]
    _, args = _inputs(bits, plen, end, q_dtype=torch.float32)
    out = _split_mirror(*args, S_PROMPT, n_split, exact_rows=0)
    ref = t_dec.decode_attention_reference(*args, S_PROMPT)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    _, args = _inputs(bits, plen, end)
    out = _split_mirror(*args, S_PROMPT, n_split)
    assert torch.equal(out, t_dec.decode_attention_reference(*args, S_PROMPT))


# long rows, which the kernel splits: a 1024-slot prompt (the second row
# 600 long) and 64 generated slots at step 40, D=128 as the serving paths
LONG = dict(plen=[1024, 600], end=[1024 + 41] * 2, s_prompt=1024,
            s_total=1024 + 64, d=128)


@pytest.mark.parametrize("bits", [8, 4])
def test_long_rows_split_within_k3_limit(bits):
    """Rows of 641 and 1065 visible slots, which the kernel splits, stay
    within K3's limit of the plain version (bf16 probabilities rounded
    before normalising), and within a bf16 tolerance of the Pallas kernel
    in interpret mode, which rounds them after."""
    jax_args, args = _inputs(bits, LONG["plen"], LONG["end"], seed=1,
                             d=LONG["d"], s_total=LONG["s_total"])
    ref = t_dec.decode_attention_reference(*args, LONG["s_prompt"]).float()
    lo, hi = _split_rows(args[5], args[6], LONG["s_prompt"],
                              LONG["s_total"], 7)
    assert (hi[:, -1] >= t_dec.EXACT_ROWS).all()
    for n_split in (1, 2, 7):
        out = _split_mirror(*args, LONG["s_prompt"], n_split).float()
        assert torch.all((out - ref).abs() <= K3_TOL["atol"]
                         + K3_TOL["rtol"] * ref.abs()), n_split
    pallas = j_dec.decode_attention_quantized(*jax_args, LONG["s_prompt"],
                                              interpret=True)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(pallas.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_split_rows_shares_and_empty_splits():
    """Equal shares of the renumbered visible rows, in order, covering
    them once; a row with fewer visible rows than splits leaves the last
    splits empty."""
    plen = torch.tensor([16, 11, 2], dtype=torch.int32)
    end = torch.tensor([20, 20, 17], dtype=torch.int32)
    lo, hi = _split_rows(plen, end, 16, 24, 7)
    n_vis = [20, 15, 3]
    for r in range(3):
        assert lo[r, 0] == 0 and hi[r, -1] == n_vis[r]
        assert torch.equal(lo[r, 1:], hi[r, :-1])
        assert (hi[r] - lo[r]).max() == -(-n_vis[r] // 7)
    assert (hi[2] - lo[2]).tolist() == [1, 1, 1, 0, 0, 0, 0]


def test_split_count_from_static_shapes():
    """The serving paths' calls on the H100's 132 SMs, and the bounds:
    at least 1, at most one split per 128 cache slots and at most 64."""
    sms = t_dec.H100_SMS
    assert t_dec.split_count(4, 8, 1792, sms) == 9
    assert t_dec.split_count(1, 8, 1792, sms) == 14
    assert t_dec.split_count(112, 8, 1792, sms) == 1
    assert t_dec.split_count(2, 2, 24, sms) == 1
    for b in (1, 3, 16, 500):
        n = t_dec.split_count(b, 8, 4096, sms)
        assert 1 <= n <= 4096 // 128
    assert t_dec.split_count(1, 1, 1 << 20, sms) == t_dec.MAX_SPLIT


def test_check_operands_takes_a_long_cache():
    """The kernel keeps no per-row scores in shared memory, so a long
    cache is taken (the former design refused 65,536 slots at group 2);
    what the kernel does not take is still refused at that length."""
    b, h, hkv, d, sk = 1, 4, 2, 128, 65536
    q = torch.zeros(b, 1, h, d, dtype=torch.bfloat16)
    sc = torch.zeros(b, hkv, sk, dtype=torch.bfloat16)
    n = torch.zeros(b, dtype=torch.int32)
    for row, name in ((d, "decode_attention_int8"),
                      (d // 2, "decode_attention_int4")):
        kv = torch.empty(b, hkv, sk, row, dtype=torch.int8)
        assert t_dec.check_operands(q, kv, sc, kv, sc, n, n) == name
        with pytest.raises(ValueError):
            t_dec.check_operands(q, kv.to(torch.uint8), sc, kv, sc, n, n)
        with pytest.raises(ValueError):
            t_dec.check_operands(q.float(), kv, sc, kv, sc, n, n)
