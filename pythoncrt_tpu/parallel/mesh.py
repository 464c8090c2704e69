"""Multi-chip sharding (jax.sharding + shard_map over a device Mesh).

The reference's only parallelism is a 2-worker host thread pool over
frames with in-order drain (crt_filter.py:1015-1017, :1081-1131). Here
the same two axes scale across devices (SURVEY.md §2.3):

- **Frame-axis DP** (single clip): the batch axis is sharded across the
  mesh. Every stage is frame-local except the persistence IIR
  s_t = p*s_{t-1} + (1-p)*x_t. Each shard reduces its chunk to the pair
  (A_i, b_i) = (p^{n_i}, local-scan final with zero init); a
  Hillis-Steele prefix composition over the shard axis — ceil(log2(n))
  ppermute rounds of ONE frame each, composing (A2*A1, A2*b1 + b2) —
  gives every shard its incoming carry, which corrects its local
  outputs as y_t + p^(t+1) * carry_in. Exactly the ring/context-
  parallel treatment of a linear recurrence, in one shard_map.
  Shard 0 absorbs the stream head (first-frame passthrough / carried
  state) into its summary as a CONSTANT affine map (A=0), so no extra
  collective is spent on it. Per-step collective budget: log2(n)+1
  one-frame ppermutes + one masked psum for the replicated carry-out
  (about 6 frame transfers per device at n=8) vs 2(n-1) for the
  all_gather form (PCRT_SHARD_COLLECTIVE=all_gather keeps that form
  for A/B).

- **Clip-axis DP** (batch renders): clips are independent streams —
  shard the clip axis, zero collectives (BASELINE.json config 5).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..engine import CRTEngine, FrameAux
from ..ops import color as ocolor

FRAME_AXIS = "frames"
CLIP_AXIS = "clips"


def make_mesh(n_devices: Optional[int] = None, axis: str = FRAME_AXIS) -> Mesh:
    """1-D mesh over the first n devices. The axis follows the
    algorithm alone: the devices of one host reach each other all to
    all (NVLink), so device order carries no topology."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (axis,))


def _check_frame_dims(engine: CRTEngine, frame_dims) -> None:
    """Per-frame dims must match the engine's layout contract; a layout
    mismatch otherwise surfaces as a cryptic shape error deep inside the
    jitted step."""
    exp = (3, engine.h, engine.w) if engine.layout == "planar" \
        else (engine.h, engine.w, 3)
    if tuple(frame_dims) != exp:
        raise ValueError(
            f"frame shape {tuple(frame_dims)} does not match engine "
            f"layout={engine.layout!r} (expected {exp})")


def _aux_present(engine: CRTEngine, field: str) -> bool:
    """Whether engine.make_aux populates the given host-rng FrameAux
    field (the sharding specs must mirror make_aux's Nones exactly)."""
    p = engine.params
    if engine.rng != "host":
        return False
    if field == "noise":
        return p.noise_on
    if field == "glitch_base":
        return p.glitch_on and engine._glitch_rows > 0
    if field == "glitch_seg":
        return (
            p.glitch_on and engine._glitch_rows > 0 and engine.engine == "export"
        )
    return False


class ShardedCRTEngine:
    """Frame-axis data-parallel wrapper around a CRTEngine.

    process(frames, indices, state) shards the batch across the mesh;
    batch size must be a multiple of the mesh size. The persistence
    carry crosses shard boundaries via a log2(ndev)-round ppermute
    prefix composition of per-shard (A, b) summaries (one frame per
    round per device — see the module docstring for the byte budget).

    It accepts the engine's planar layout and offers process_stack
    dispatch batching exactly like CRTEngine.
    """

    def __init__(self, engine: CRTEngine, mesh: Optional[Mesh] = None) -> None:
        self.engine = engine
        self.mesh = mesh if mesh is not None else make_mesh()
        self.ndev = self.mesh.devices.size
        p = engine.params
        self._persist = p.persistence_on
        self._pp = np.float32(p.persistence)
        self._om = np.float32(1.0 - p.persistence)
        self._build()

    def _build(self) -> None:
        import os

        eng = self.engine
        pp, om, persist = self._pp, self._om, self._persist
        axis = FRAME_AXIS
        ndev = self.ndev
        # collective form A/B (module docstring): the ppermute prefix
        # scan moves ~log2(n)+3 frames/device/step, the all_gather form
        # ~2(n-1). Kept switchable for on-hardware comparison; the math
        # differs only in f32 combine order.
        use_gather = os.environ.get("PCRT_SHARD_COLLECTIVE") == "all_gather"

        def broadcast_from_last(val):
            # replicate the last shard's value: a masked psum moves
            # ~2 frames/device (reduce + broadcast) vs the (n-1)-frame
            # all_gather it replaces
            my = jax.lax.axis_index(axis)
            return jax.lax.psum(
                jnp.where(my == ndev - 1, val, jnp.zeros_like(val)), axis)

        def chain_dim(x):
            # broadcast rank for per-frame scalars vs frame arrays
            return (slice(None),) + (None,) * (x.ndim - 1)

        def local_block(frames_u8, aux, state, first_arr, c):
            """Runs per shard. state/first/consts replicated;
            frames/aux sharded. Layout-agnostic: frames/state follow
            the ENGINE's layout ((B, H, W, 3) or planar (B, 3, H, W));
            every op below is elementwise or batch-axis-only."""
            if eng.layout == "planar":
                # mirror CRTEngine._step: convert at the shard-local
                # edges
                pc = np.array(eng._plane_colors)
                inv = np.argsort(pc)
                frames_u8 = jnp.transpose(frames_u8, (0, 2, 3, 1))[..., inv]
                state = jnp.transpose(state, (1, 2, 0))[..., inv]
                out, ns = local_core(frames_u8, aux, state, first_arr, c)
                return (jnp.transpose(out[..., pc], (0, 3, 1, 2)),
                        jnp.transpose(ns[..., pc], (2, 0, 1)))
            return local_core(frames_u8, aux, state, first_arr, c)

        def local_core(frames_u8, aux, state, first_arr, c):
            imgs = eng._batch_effects(frames_u8, aux, c)
            if not persist:
                # _finish owns the uint8 cast. The carried state is the
                # GLOBAL last frame — each shard's
                # _finish returns its LOCAL tail; broadcast the last
                # shard's (a P() out-spec would silently keep shard 0's).
                outs, st = eng._finish(imgs, state, first_arr)
                return outs, broadcast_from_last(st)

            my = jax.lax.axis_index(axis)
            n_local = imgs.shape[0]
            first = first_arr[0]

            # Local zero-init scan: y_t, plus p^(t+1) factors.
            def blend0(prev, cur):
                b = pp * prev + om * cur
                return b, b

            y_last, y = jax.lax.scan(blend0, jnp.zeros_like(imgs[0]), imgs)
            tpow = pp ** jnp.arange(1, n_local + 1, dtype=jnp.float32)

            # Per-shard affine summary T_i(x) = A_i x + b_i.
            # Shard 0 absorbs the stream head: first-frame passthrough
            # equals carrying s_{-1} = x_0 (crt_filter.py:1094-1095),
            # reconstructed LOCALLY from y_0 = (1-p) * x_0; otherwise
            # the replicated incoming state. Its summary becomes the
            # CONSTANT map A=0, b = T_0(s_init) — so the stream head
            # rides the prefix scan instead of its own all_gather.
            A_loc = jnp.float32(pp ** n_local)
            s_init = jnp.where(first, y[0] / om, state)
            is0 = my == 0
            A_i = jnp.where(is0, jnp.float32(0.0), A_loc)
            b_i = jnp.where(is0, A_loc * s_init + y_last, y_last)

            if use_gather:
                b_all = jax.lax.all_gather(b_i, axis)  # (ndev, ...)
                A_all = jax.lax.all_gather(A_i, axis)  # (ndev,)
                # exclusive left fold over shards j < my (shard 0's
                # constant map carries s_init, so zeros is the right
                # fold seed for every my >= 1)
                carry = jnp.zeros_like(b_i)
                for j in range(ndev):
                    carry = jnp.where(j < my, A_all[j] * carry + b_all[j],
                                      carry)
                # valid only on shard ndev-1 (its carry is the full
                # exclusive prefix); broadcast_from_last masks the rest
                incl_last = A_all[ndev - 1] * carry + b_all[ndev - 1]
                new_state = jnp.clip(broadcast_from_last(incl_last), 0.0, 1.0)
                carry = jnp.where(my == 0, s_init, carry)
            else:
                # Hillis-Steele inclusive prefix composition over the
                # shard axis: ceil(log2(n)) ppermute rounds, one frame
                # (b) + one scalar (A) each. Composing the INCOMING
                # prefix before the current: (A, b) <- (A*A_in,
                # A*b_in + b). Non-receiving shards keep their pair.
                A_c, b_c = A_i, b_i
                d = 1
                while d < ndev:
                    perm = [(i, i + d) for i in range(ndev - d)]
                    A_in = jax.lax.ppermute(A_c, axis, perm)
                    b_in = jax.lax.ppermute(b_c, axis, perm)
                    take = my >= d
                    b_c = jnp.where(take, A_c * b_in + b_c, b_c)
                    A_c = jnp.where(take, A_c * A_in, A_c)
                    d *= 2
                # shard i now holds T_{0..i}; since shard 0's map is
                # constant (A=0), every inclusive prefix is constant and
                # its b IS the running state. Exclusive carry = shift by
                # one shard; shard 0's carry is s_init itself.
                b_shift = jax.lax.ppermute(
                    b_c, axis, [(i, i + 1) for i in range(ndev - 1)])
                carry = jnp.where(my == 0, s_init, b_shift)
                new_state = jnp.clip(broadcast_from_last(b_c), 0.0, 1.0)

            outs = jnp.clip(y + tpow[chain_dim(y)] * carry, 0.0, 1.0)
            return ocolor.to_uint8(outs), new_state

        in_specs = (
            P(axis),  # frames
            FrameAux(
                frame_idx=P(axis),
                phase=P(axis),
                flicker=P(axis),
                noise=P(axis) if self._aux_has("noise") else None,
                glitch_base=P(axis) if self._aux_has("glitch_base") else None,
                glitch_seg=P(axis) if self._aux_has("glitch_seg") else None,
            ),
            P(),  # state (replicated)
            P(),  # first flag (replicated)
            jax.tree.map(lambda _: P(), eng._c),  # consts (replicated)
        )
        out_specs = (P(axis), P())
        self._step = jax.jit(
            jax.shard_map(
                local_block, mesh=self.mesh, in_specs=in_specs,
                out_specs=out_specs, check_vma=False,
            )
        )

        def multi_block(frames_stack, aux_stack, state, first_arr, c):
            # n sequential shard-local chunks in ONE dispatch — the
            # same lax.scan dispatch amortization as
            # CRTEngine._multi_step, with the collectives running
            # inside the scan body (legal under shard_map; one
            # ppermute chain per chunk).
            def body(carry, xs):
                st, first = carry
                frames, aux = xs
                out, ns = local_block(frames, aux, st, first, c)
                return (ns, jnp.zeros_like(first)), out

            (ns, _), outs = jax.lax.scan(
                body, (state, first_arr), (frames_stack, aux_stack))
            return outs, ns

        stack_specs = (
            P(None, axis),  # (n, B, ...) frame stacks: chunk axis whole
            FrameAux(
                frame_idx=P(None, axis),
                phase=P(None, axis),
                flicker=P(None, axis),
                noise=P(None, axis) if self._aux_has("noise") else None,
                glitch_base=(P(None, axis)
                             if self._aux_has("glitch_base") else None),
                glitch_seg=(P(None, axis)
                            if self._aux_has("glitch_seg") else None),
            ),
            P(),
            P(),
            jax.tree.map(lambda _: P(), eng._c),
        )
        self._mstep = jax.jit(
            jax.shard_map(
                multi_block, mesh=self.mesh, in_specs=stack_specs,
                out_specs=(P(None, axis), P()), check_vma=False,
            )
        )

    def _aux_has(self, field: str) -> bool:
        return _aux_present(self.engine, field)

    def process(self, frames_u8, frame_indices=None, state=None):
        frames_u8 = jnp.asarray(frames_u8)
        b = frames_u8.shape[0]
        _check_frame_dims(self.engine, frames_u8.shape[1:])
        if b % self.ndev != 0:
            raise ValueError(f"batch {b} not divisible by mesh size {self.ndev}")
        if frame_indices is None:
            frame_indices = np.arange(b)
        aux = self.engine.make_aux(np.asarray(frame_indices))
        first = state is None
        if first:
            state = self.engine.init_state()
        first_arr = jnp.full((1,), first, jnp.bool_)
        out, new_state = self._step(frames_u8, aux, state, first_arr, self.engine._c)
        return out, new_state

    def process_stack(self, frames_stack, frame_indices, state=None):
        """n sequential sharded chunks in ONE device dispatch (_mstep).

        frames_stack: (n, B, ...) uint8 in the engine's layout;
        frame_indices: (n, B). Bitwise identical to n successive
        process() calls — the carry threads chunk-to-chunk inside a
        lax.scan under the SAME shard_map, so each chunk still pays
        exactly one ppermute prefix chain; only the per-call dispatch
        overhead amortizes (pipeline.py steps_per_call, now first-class
        under sharding)."""
        frames_stack = jnp.asarray(frames_stack)
        n, b = frames_stack.shape[:2]
        _check_frame_dims(self.engine, frames_stack.shape[2:])
        if b % self.ndev != 0:
            raise ValueError(f"batch {b} not divisible by mesh size {self.ndev}")
        idx = np.asarray(frame_indices)
        aux = self.engine.make_aux(idx.reshape(-1))
        aux = jax.tree.map(
            lambda a: jnp.reshape(a, (n, b) + a.shape[1:]), aux)
        first = state is None
        if first:
            state = self.engine.init_state()
        outs, new_state = self._mstep(
            frames_stack, aux, state, jnp.full((1,), first, jnp.bool_),
            self.engine._c)
        return outs, new_state


class MultiClipEngine:
    """Clip-axis data parallelism: C independent clips, one per shard
    group, no collectives (BASELINE.json config 5).

    process(frames (C, B, H, W, 3), indices (C, B), states (C, H, W, 3))
    — or (C, B, 3, H, W) / (C, 3, H, W) when the engine was built with
    layout="planar".

    rng="host" is supported: every host-rng aux field is a
    pure function of the frame index (engine.make_aux seeds each frame's
    noise as (seed, index) and derives the glitch fields from the
    frame's phase — engine.py make_aux), so clips sharing frame indices
    draw IDENTICAL streams — exactly what N independent single-clip
    renders with the same seed produce. The aux shards clip-major like
    the frames.
    """

    def __init__(self, engine: CRTEngine, mesh: Optional[Mesh] = None) -> None:
        self.engine = engine
        self.mesh = mesh if mesh is not None else make_mesh(axis=CLIP_AXIS)
        self.ndev = self.mesh.devices.size
        axis = CLIP_AXIS
        edge_convert = engine.layout == "planar"

        def core(flat, aux, states, first_arr, c):
            # Frames arrive FLAT and clip-major (C*B, H, W, 3): sharding
            # the leading axis hands each device exactly its clips'
            # frames with no reshape inside the jitted body. Clips are
            # independent, so the effects see one flat batch; only the
            # persistence carry is clip-aware.
            imgs = engine._batch_effects(flat, aux, c)
            cl = states.shape[0]
            b = flat.shape[0] // cl
            imgs = imgs.reshape((cl, b) + imgs.shape[1:])
            outs, new_states = jax.vmap(
                lambda im, s: engine._finish(im, s, first_arr)
            )(imgs, states)
            return outs.reshape((cl * b,) + outs.shape[2:]), new_states

        def per_shard(flat, aux, states, first_arr, c):
            if edge_convert:
                # mirror CRTEngine._step: convert to NHWC at the shard
                # edges, run the NHWC core, convert back
                pc = np.array(engine._plane_colors)
                inv = np.argsort(pc)
                flat = jnp.transpose(flat, (0, 2, 3, 1))[..., inv]
                states = jnp.transpose(states, (0, 2, 3, 1))[..., inv]
                out, ns = core(flat, aux, states, first_arr, c)
                return (jnp.transpose(out[..., pc], (0, 3, 1, 2)),
                        jnp.transpose(ns[..., pc], (0, 3, 1, 2)))
            return core(flat, aux, states, first_arr, c)

        if self.ndev == 1:
            # single visible device: the body IS the whole batch — jit
            # it directly, with no shard_map boundary around it;
            # multi-device meshes keep the sharded wrapper.
            body = per_shard
        else:
            def aux_spec(field):
                # host-rng fields shard clip-major like the frames
                # (frame-index-keyed streams; see class docstring)
                return P(axis) if self._aux_has(field) else None

            body = jax.shard_map(
                per_shard,
                mesh=self.mesh,
                in_specs=(
                    P(axis),  # flat frames, clip-major
                    FrameAux(P(axis), P(axis), P(axis), aux_spec("noise"),
                             aux_spec("glitch_base"), aux_spec("glitch_seg")),
                    P(axis),  # per-clip states
                    P(),  # first flag (replicated)
                    jax.tree.map(lambda _: P(), engine._c),
                ),
                out_specs=(P(axis), P(axis)),
                check_vma=False,
            )
        self._step = jax.jit(body)

        def multi(flat_stack, aux_stack, states, first_arr, c):
            # n sequential clip-batches in ONE dispatch (same scan-based
            # dispatch amortization as CRTEngine._multi_step; the
            # per-clip states thread chunk-to-chunk)
            def sbody(carry, xs):
                st, first = carry
                flat, aux = xs
                outs, ns = body(flat, aux, st, first, c)
                return (ns, jnp.zeros_like(first)), outs

            (ns, _), outs = jax.lax.scan(
                sbody, (states, first_arr), (flat_stack, aux_stack))
            return outs, ns

        self._mstep = jax.jit(multi)

    def _aux_has(self, field: str) -> bool:
        return _aux_present(self.engine, field)

    def _check_frame_shape(self, frame_dims) -> None:
        _check_frame_dims(self.engine, frame_dims)

    def process(self, frames_u8, frame_indices, states=None):
        frames_u8 = jnp.asarray(frames_u8)
        c, b = frames_u8.shape[0], frames_u8.shape[1]
        self._check_frame_shape(frames_u8.shape[2:])
        if c % self.ndev != 0:
            raise ValueError(f"clip count {c} not divisible by mesh size {self.ndev}")
        idx = np.asarray(frame_indices)
        # flatten OUTSIDE the jitted step (clip-major: shard boundaries
        # coincide with clip boundaries)
        flat = frames_u8.reshape((c * b,) + frames_u8.shape[2:])
        aux = self.engine.make_aux(idx.reshape(-1))
        first = states is None
        if first:
            # stream start: each clip's frame 0 passes through unblended
            # (crt_filter.py:1094-1095), handled by the first flag inside
            # _finish exactly as in ShardedCRTEngine/CRTEngine.
            # derive the per-clip state shape from the engine's layout
            # contract rather than hardcoding NHWC (advisor r3)
            states = jnp.zeros((c,) + self.engine.init_state().shape,
                               jnp.float32)
        first_arr = jnp.full((1,), first, jnp.bool_)
        outs, new_states = self._step(flat, aux, states, first_arr, self.engine._c)
        return outs.reshape((c, b) + outs.shape[1:]), new_states

    def process_stack(self, frames_stack, frame_indices, states=None):
        """n sequential clip-batches in ONE device dispatch (_mstep).

        frames_stack: (n, C, B, H, W, 3) uint8; frame_indices: (n, C, B).
        Bitwise identical to n successive process() calls (tested) —
        the per-clip persistence states thread chunk-to-chunk inside a
        lax.scan, paying one dispatch's launch overhead per n chunks,
        exactly as CRTEngine.process_stack does for the plain engine.
        """
        frames_stack = jnp.asarray(frames_stack)
        n, c, b = frames_stack.shape[:3]
        self._check_frame_shape(frames_stack.shape[3:])
        if c % self.ndev != 0:
            raise ValueError(f"clip count {c} not divisible by mesh size {self.ndev}")
        idx = np.asarray(frame_indices).reshape(n, c * b)
        flat = frames_stack.reshape((n, c * b) + frames_stack.shape[3:])
        aux = self.engine.make_aux(idx.reshape(-1))
        aux = jax.tree.map(
            lambda a: jnp.reshape(a, (n, c * b) + a.shape[1:]), aux)
        first = states is None
        if first:
            states = jnp.zeros((c,) + self.engine.init_state().shape,
                               jnp.float32)
        outs, new_states = self._mstep(
            flat, aux, states, jnp.full((1,), first, jnp.bool_),
            self.engine._c)
        return outs.reshape((n, c, b) + outs.shape[2:]), new_states
