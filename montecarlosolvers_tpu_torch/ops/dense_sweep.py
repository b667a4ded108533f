"""Blocked-sequential Metropolis sweep of a DenseProblem: plain versions.

Counterpart of `montecarlosolvers_tpu/ops/dense_sweep.py`. The reference's
sequential single-spin sweep (sa.pyx:81-99) is exact but serial, and the
colored-parallel transform needs sparse structure. For a fully-connected
problem the sweep keeps the sequential semantics and restructures the
work:

  * the fields of a block of B spins are one (chains, N) x (N, B) matrix
    product, `torch.matmul`, as the JAX package leaves its `jnp.dot` to XLA;
  * within the block the spins update one at a time, and each flip applies
    a rank-1 delayed update to the block's fields (f_k += (s' - s_i) J_ik),
    so the sweep is exactly sequential Metropolis in systematic-scan order;
  * the next block's fields are computed afresh, every earlier flip then
    reflected through the product.

Here are the plain versions: `dense_metropolis_sweep`, the JAX sweep with
its uniforms and its visit order as arguments (a test feeds it the JAX
sweep's own `jax.random` draws), and `block_steps`, the B micro-steps of
one block. The CUDA kernel of the micro-steps (`csrc/dense_sa.cu`), its
wrapper and the anneals on the counter hash are in `ops/dense_kernels.py`.

Two options, as in the JAX package: a visit order `perm` (shuffle=True
there: J, h and s are permuted once up front, so the blocked products are
untouched), and `matmul_dtype` (e.g. torch.bfloat16): the couplings are
rounded to it and upcast to float32, so the products of bf16 values are
exact and the sums run in float32, the semantics of the JAX
`preferred_element_type=float32`. The sweep is then exact sequential
Metropolis on the rounded problem; on +/-1 couplings the rounding is
lossless and the spins are float32's bitwise.
"""

from __future__ import annotations

import torch

from montecarlosolvers_tpu_torch.ops.metropolis import metropolis_accept


def block_size(block, n):
    """The block B of a sweep of n spins: `block`, at most n."""
    return min(int(block), int(n))


def padded_size(n, B):
    """N rounded up to whole blocks of B."""
    return -(-n // B) * B


def rounded(J, matmul_dtype):
    """J as the products see it: rounded to `matmul_dtype` and upcast to
    float32 (None: J itself)."""
    if matmul_dtype is None or matmul_dtype == torch.float32:
        return J
    return J.to(matmul_dtype).to(torch.float32)


def padded(J, h, s, B):
    """(J, h, s) padded to whole blocks of B: zero couplings and fields and
    +1 spins, whose flips have dE = 0, are always accepted and touch no
    real spin's field (montecarlosolvers_tpu/ops/dense_sweep.py:80-85).
    Returns contiguous tensors."""
    n = J.shape[0]
    pad = padded_size(n, B) - n
    if pad:
        J = torch.nn.functional.pad(J, (0, pad, 0, pad))
        h = torch.nn.functional.pad(h, (0, pad))
        s = torch.nn.functional.pad(s, (0, pad), value=1.0)
    return J.contiguous(), h.contiguous(), s.contiguous()


def block_fields(s, J, h, start, B):
    """(C, B) fields s @ J[:, start:start+B] + h[start:start+B] of padded
    (C, Np) spins: one `torch.matmul`, then the fields, in float32."""
    return torch.matmul(s, J[:, start:start + B]) + h[start:start + B]


def block_steps(s, fb, J, start, u, temp):
    """The B sequential Metropolis micro-steps of the block at `start`, in
    place on padded (C, Np) spins `s`: fb (C, B) the block's fields from
    `block_fields`, u (C, B) one uniform a site, temp a float32 tensor.
    Step j flips site i = start + j on dE = -2 s_i f_j and adds (s_i' -
    s_i) J[i, block] to the fields: d in {0, +/-2} makes the product exact,
    so no contraction can change the sum."""
    B = fb.shape[1]
    for j in range(B):
        i = start + j
        si = s[:, i]
        de = -2.0 * si * fb[:, j]
        s_new = torch.where(metropolis_accept(de, temp, u[:, j]), -si, si)
        fb = fb + (s_new - si)[:, None] * J[i, start:start + B][None, :]
        s[:, i] = s_new
    return s


def dense_metropolis_sweep(dp, s, u, temp, block=128, perm=None,
                           matmul_dtype=None):
    """One sequential Metropolis sweep (JAX `dense_metropolis_sweep`,
    ops/dense_sweep.py:45).

    dp: DenseProblem; s: (C, N) float32 +/-1; u: (C, Np) uniforms, Np = N
    rounded up to whole blocks of min(block, N), one per padded position in
    visit order (the JAX sweep's `jax.random.uniform(key, (C, Np))`); temp:
    float32 tensor; perm: None for the systematic scan 0..N-1, or an (N,)
    visit order (shuffle=True there: `jax.random.permutation`);
    matmul_dtype: see the module docstring. Returns the new (C, N) spins
    in natural order."""
    C, N = s.shape
    B = block_size(block, N)
    J, h = dp.J, dp.h
    if perm is not None:
        perm = torch.as_tensor(perm, device=s.device).long()
        J, h, s = J[perm][:, perm], h[perm], s[:, perm]
    J, h, s = padded(rounded(J, matmul_dtype), h, s.clone(), B)
    for start in range(0, J.shape[0], B):
        fb = block_fields(s, J, h, start, B)
        block_steps(s, fb, J, start, u[:, start:start + B], temp)
    s = s[:, :N]
    if perm is not None:
        out = torch.empty_like(s)
        out[:, perm] = s
        s = out
    return s
