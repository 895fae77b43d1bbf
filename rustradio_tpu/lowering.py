"""Segment lowering: block patterns -> the fused FM kernel.

The reference's flagship throughput comes from plain block composition
(examples/ax25-1200-rx.rs:191-336).  Here the analogous promise is that a
user-built flowgraph reaches the framework's headline fused kernel: when a
fused device segment contains the FM shape

    [FloatToComplex ->] FirFilter(real taps, deci) -> QuadratureDemod

the graph runners execute it as ONE ``ops.fm_chain`` kernel pass (FIR on
both I/Q planes + discriminator, with the filtered stream never leaving
registers) instead of two kernels with a device-memory round trip
between.  This happens where the kernel runs (``backend.use_kernels``:
the GPU); elsewhere the graph keeps the exact composed ops.  With the
FloatToComplex prefix the I/Q planes feed the kernel directly and the
complex stream never materializes.

Numerics: the fused kernel uses the polynomial fast atan2 (~1e-4 rad —
the same trade the reference ships as its ``fast-math`` feature,
src/quadrature_demod.rs:28-29) and its own accumulation order, so
lowered output differs from the composed path by <~2e-4; chunked
execution equals the lowered offline stream except at chunk seams
(<1e-6, the seam sample is recomputed by one full-window dot).
Exactness is gated in tests/test_pallas_interpret.py.

State compatibility: the lowered streaming form reads and writes the
ORIGINAL blocks' state pytrees (FirFilter's {buf, out_off} raw-input
carry and QuadratureDemod's 1-sample tail), so checkpoints, the scan
precheck, and mesh demotion interoperate with the unlowered path
unchanged.
"""

from __future__ import annotations

import numpy as np


def _is_fm_fir(block) -> bool:
    from .blocks.filters import FirFilter
    from .ops.fm import kernel_takes

    return (
        isinstance(block, FirFilter)
        and block.translate is None
        and kernel_takes(block.taps, block.deci, block.precision)
    )


def find_fm_pairs(seg, ext_out):
    """Lowerable runs inside a fused segment.

    Returns ``(plans, consumed)``: ``plans`` maps the run's LAST node idx
    (the QuadratureDemod) to a dict describing the fused execution, and
    ``consumed`` is the set of member idxs whose normal execution is
    replaced.  A run only lowers when its interior ports feed nothing
    else (no Tee mid-pattern, not segment outputs).
    """
    from .blocks.demod import QuadratureDemod
    from .blocks.elementwise import FloatToComplex

    by_idx = {n.idx: n for n in seg}
    consumers: dict[tuple[int, int], int] = {}
    for n in seg:
        for p in n.inputs:
            key = (p.node.idx, p.index)
            consumers[key] = consumers.get(key, 0) + 1

    def only_feeds(src_node, dst_node) -> bool:
        key = (src_node.idx, 0)
        return (
            consumers.get(key, 0) == 1
            and key not in ext_out
            and len(dst_node.inputs) == 1
            and dst_node.inputs[0].node.idx == src_node.idx
        )

    plans: dict[int, dict] = {}
    consumed: set[int] = set()
    for n in seg:
        if not isinstance(n.block, QuadratureDemod):
            continue
        if len(n.inputs) != 1:
            continue
        fir = by_idx.get(n.inputs[0].node.idx)
        if fir is None or fir.idx in consumed or not _is_fm_fir(fir.block):
            continue
        if not only_feeds(fir, n):
            continue
        plan = {
            "fir": fir,
            "quad": n,
            "taps": np.real(fir.block.taps).astype(np.float32),
            "deci": fir.block.deci,
            "gain": float(n.block.gain),
            "precision": getattr(fir.block, "precision", "highest"),
            "f2c": None,
        }
        f2c = by_idx.get(fir.inputs[0].node.idx) if fir.inputs else None
        if (
            f2c is not None
            and isinstance(f2c.block, FloatToComplex)
            and f2c.idx not in consumed
            and only_feeds(f2c, fir)
        ):
            plan["f2c"] = f2c
            consumed.add(f2c.idx)
        consumed.add(fir.idx)
        consumed.add(n.idx)
        plans[n.idx] = plan
    return plans, consumed


def _alignment(ntaps: int, deci: int):
    """Left zero-pad and kernel-output offset mapping valid-conv FIR
    alignment onto the kernel's full-conv grid: valid output k is
    the kernel's filtered sample k + d0 after padding p zeros."""
    p = (-(ntaps - 1)) % deci
    d0 = (ntaps - 1 + p) // deci
    return p, d0


def _fused_planes(xr, xi, taps, deci, gain, precision, n_fir):
    """Kernel demod pairs of the valid filtered stream: element k is
    demod(y_valid[k], y_valid[k+1]), length n_fir - 1."""
    import jax.numpy as jnp

    from .ops.fm import fm_chain_kernel

    ntaps = len(taps)
    p, d0 = _alignment(ntaps, deci)
    if p:
        xr = jnp.pad(xr, (p, 0))
        xi = jnp.pad(xi, (p, 0))
    audio = fm_chain_kernel(xr, xi, taps, deci, gain, precision)
    # audio[j] = demod(y_full[j], y_full[j+1]); y_valid[k] = y_full[k+d0]
    return audio[d0 : d0 + n_fir - 1]


def _y_valid_at(xr, xi, taps, deci, precision, ks):
    """Filtered valid samples y_valid[k] for a static index list, by
    direct f32 (HIGHEST) dots over the planes rounded as the kernel
    rounds them (seam values; tiny next to the kernel)."""
    import jax
    import jax.numpy as jnp

    from .ops.fm import round_planes

    trev = jnp.asarray(taps[::-1].copy())
    ntaps = len(taps)
    wr = round_planes(jnp.stack(
        [jax.lax.dynamic_slice_in_dim(xr, k * deci, ntaps) for k in ks]
    ), precision)
    wi = round_planes(jnp.stack(
        [jax.lax.dynamic_slice_in_dim(xi, k * deci, ntaps) for k in ks]
    ), precision)
    yr = jnp.dot(wr, trev, precision=jax.lax.Precision.HIGHEST)
    yi = jnp.dot(wi, trev, precision=jax.lax.Precision.HIGHEST)
    return yr, yi


def fused_fm_apply(plan, *xs):
    """Offline form: complex x (pattern A) or (re, im) planes (pattern
    B) -> quadrature_demod(fir_filter(x, taps, deci), gain) with the
    kernel's numerics."""
    import jax.numpy as jnp

    taps, deci = plan["taps"], plan["deci"]
    if plan["f2c"] is not None:
        xr = jnp.asarray(xs[0], jnp.float32)
        xi = jnp.asarray(xs[1], jnp.float32)
    else:
        x = jnp.asarray(xs[0])
        xr = jnp.real(x).astype(jnp.float32)
        xi = jnp.imag(x).astype(jnp.float32)
    n = xr.shape[0]
    n_fir = (n - len(taps)) // deci + 1
    return _fused_planes(xr, xi, taps, deci, plan["gain"],
                         plan["precision"], n_fir)


def fused_fm_chunk(plan, st_fir, st_quad, *xs):
    """Streaming form over the ORIGINAL blocks' states.

    ``st_fir`` — FirFilter's {"buf": raw-input tail, "out_off": int};
    ``st_quad`` — QuadratureDemod's carried last filtered sample
    ((0,) complex at stream start, (1,) after).  Returns
    (st_fir', st_quad', demod chunk).
    """
    import jax
    import jax.numpy as jnp

    taps, deci, gain = plan["taps"], plan["deci"], plan["gain"]
    ntaps = len(taps)
    if plan["f2c"] is not None:
        re = jnp.asarray(xs[0], jnp.float32)
        im = jnp.asarray(xs[1], jnp.float32)
        buf = jnp.asarray(st_fir["buf"])
        if buf.shape[0] == 0:
            # stream start: FirFilter.init_state's empty f32 buf
            br = bi = jnp.zeros(0, jnp.float32)
        else:
            br = jnp.real(buf).astype(jnp.float32)
            bi = jnp.imag(buf).astype(jnp.float32)
        xr = jnp.concatenate([br, re])
        xi = jnp.concatenate([bi, im])

        def mk_buf(r, i):
            return jax.lax.complex(r, i)
    else:
        x = jnp.asarray(xs[0], jnp.complex64)
        buf = jnp.asarray(st_fir["buf"], x.dtype)
        ext = jnp.concatenate([buf, x])
        xr = jnp.real(ext).astype(jnp.float32)
        xi = jnp.imag(ext).astype(jnp.float32)
        mk_buf = None

    n_avail = xr.shape[0]
    out_off = st_fir["out_off"]
    if n_avail < ntaps:
        new_buf = (
            mk_buf(xr, xi) if mk_buf is not None else ext
        )
        return (
            {"buf": new_buf, "out_off": out_off},
            jnp.asarray(st_quad),
            jnp.zeros(0, jnp.float32),
        )
    n_fir = (n_avail - ntaps) // deci + 1
    consumed = n_fir * deci

    inner = _fused_planes(xr, xi, taps, deci, gain, plan["precision"], n_fir)
    # seam output: demod(prev_y, y_valid[0]) when a previous filtered
    # sample is carried; plus the new carried y_valid[n_fir-1]
    y0r, y0i = _y_valid_at(xr, xi, taps, deci, plan["precision"],
                           [0, n_fir - 1])
    prev = jnp.asarray(st_quad, jnp.complex64)
    if prev.shape[0]:
        pr = jnp.real(prev[0]).astype(jnp.float32)
        pi = jnp.imag(prev[0]).astype(jnp.float32)
        from .ops.demod import fast_atan2

        dr = pr * y0r[0] + pi * y0i[0]
        di = pr * y0i[0] - pi * y0r[0]
        first = (jnp.float32(gain) * fast_atan2(di, dr))[None]
        out = jnp.concatenate([first, inner])
    else:
        out = inner
    new_quad = jax.lax.complex(y0r[1], y0i[1])[None]
    if mk_buf is not None:
        new_buf = mk_buf(xr[consumed:], xi[consumed:])
    else:
        new_buf = ext[consumed:]
    return (
        {"buf": new_buf, "out_off": out_off + n_fir},
        new_quad,
        out,
    )
