"""Checkpoint / resume.

The reference has no resume capability: a run is one synchronous call with
all state in stack locals (SURVEY.md §5). Here the full sampler state — a
pytree of arrays including PRNG keys, adaptation statistics, and draw
buffers — serializes to a single file, and :class:`ChunkedRunner` executes
any transition kernel in restartable chunks, streaming kept draws to a
:class:`mcmc_tpu.runtime.DrawSink` so a killed job resumes bit-exactly from
the last completed chunk.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from mcmc_tpu.runtime import DrawSink, read_draws

__all__ = ["save", "restore", "ChunkedRunner"]


def save(path, tree):
    """Atomically serialize a pytree of arrays (and scalars) to ``path``."""
    path = pathlib.Path(path)
    # typed PRNG keys can't pass through np.asarray; store their raw data
    # (restore() re-wraps them from the template's leaf dtype)
    leaves, treedef = jax.tree_util.tree_flatten(_key_data(tree))
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    payload = {"treedef": str(treedef), "n_leaves": len(leaves)}
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(payload), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore(path, like):
    """Restore a pytree saved by :func:`save`. ``like`` supplies the tree
    structure (and device placement targets)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    like_leaves, treedef = jax.tree_util.tree_flatten(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template has {len(like_leaves)}"
        )
    out = []
    for tmpl, arr in zip(like_leaves, leaves):
        a = jnp.asarray(arr)
        if hasattr(tmpl, "dtype") and jnp.issubdtype(tmpl.dtype, jax.dtypes.prng_key):
            # PRNG keys round-trip through key_data
            a = jax.random.wrap_key_data(arr)
        out.append(a)
    return jax.tree_util.tree_unflatten(treedef, out)


def _key_data(tree):
    """Convert typed PRNG keys to raw data for serialization."""
    def conv(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            return jax.random.key_data(x)
        return x
    return jax.tree_util.tree_map(conv, tree)


def _atomic_write_text(path, text):
    path = pathlib.Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _save_ckpt(path, keys_state, meta, totals):
    """One atomic artifact holding sampler state + progress meta + info
    totals, so no kill window can leave state and progress inconsistent
    (bit-identical resume depends on them advancing together)."""
    path = pathlib.Path(path)
    leaves, _ = jax.tree_util.tree_flatten(keys_state)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    for k, v in totals.items():
        arrays[f"total__{k}"] = np.asarray(v)
    payload = {"n_leaves": len(leaves), "meta": meta,
               "total_keys": sorted(totals)}
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(payload), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _load_ckpt(path, like):
    """Returns (keys_state, meta, totals); raises on structural mismatch."""
    with np.load(path, allow_pickle=False) as data:
        payload = json.loads(str(data["__meta__"]))
        leaves = [data[f"leaf_{i}"] for i in range(payload["n_leaves"])]
        totals = {k: np.asarray(data[f"total__{k}"])
                  for k in payload.get("total_keys", [])}
    like_leaves, treedef = jax.tree_util.tree_flatten(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template has {len(like_leaves)}"
        )
    out = []
    for tmpl, arr in zip(like_leaves, leaves):
        a = jnp.asarray(arr)
        if hasattr(tmpl, "dtype") and jnp.issubdtype(tmpl.dtype, jax.dtypes.prng_key):
            a = jax.random.wrap_key_data(arr)
        out.append(a)
    return jax.tree_util.tree_unflatten(treedef, out), payload["meta"], totals


def _merge_moments(mom, batch):
    """Chan-parallel merge of a kept-draw batch ``(k, *row)`` into running
    Welford moments ``(count, mean, m2)`` over the draw axis — exact, so
    streaming estimates equal batch estimates over the same draws."""
    batch = np.asarray(batch, np.float64)
    nb = batch.shape[0]
    mean_b = batch.mean(axis=0)
    m2_b = ((batch - mean_b) ** 2).sum(axis=0)
    if mom is None:
        return [np.asarray(nb, np.float64), mean_b, m2_b]
    na, mean_a, m2_a = mom
    n = na + nb
    delta = mean_b - mean_a
    mean = mean_a + delta * (nb / n)
    m2 = m2_a + m2_b + delta * delta * (na * nb / n)
    return [np.asarray(n, np.float64), mean, m2]


_MOM_KEYS = ("__mom_count", "__mom_mean", "__mom_m2")


def _start_host_copy(tree):
    """Kick off async device->host transfers for every leaf of ``tree``.

    jax dispatch is asynchronous, so calling this right after a chunk is
    enqueued schedules the D2H copy to run as soon as the chunk finishes on
    device — by the time ``persist`` calls ``np.asarray`` the bytes are
    already on the host (or in flight), instead of starting a synchronous
    transfer there. Typed PRNG-key leaves and non-jax leaves are skipped.
    """
    for leaf in jax.tree_util.tree_leaves(tree):
        fn = getattr(leaf, "copy_to_host_async", None)
        if fn is not None:
            try:
                fn()
            except Exception:
                pass  # e.g. typed key arrays on some backends


def _sum_info(totals, infos):
    """Fold one chunk's per-draw info traces into the running totals.

    Every numeric/bool leaf of ``infos`` (shape ``(chunk, ...)``) is summed
    over the draw axis — booleans/ints as int64 counts, floats as float64
    sums. The per-draw traces themselves are not retained in checkpointed
    runs; callers reconstruct means by dividing by the kept-draw count.
    """
    for k, v in infos.items():
        arr = np.asarray(v)
        if arr.dtype == np.bool_ or np.issubdtype(arr.dtype, np.integer):
            s = arr.sum(axis=0).astype(np.int64)
        else:
            s = arr.astype(np.float64).sum(axis=0)
        if k in totals:
            totals[k] = totals[k] + s
        else:
            totals[k] = s
    return totals


class ChunkedRunner:
    """Restartable chunked execution of a transition kernel.

    Default (per-chain keys): ``step_batched(keys, state) -> (state, info)``
    operates on chain-batched state with per-chain keys (exactly what
    ``jax.vmap`` of a single-chain kernel gives). With ``single_key=True``
    the kernel is a whole-state step ``step(key, state)`` taking one key per
    draw (the DE population sweep / AEES ladder convention).

    Draws stream to a native :class:`DrawSink`; sampler state checkpoints
    after every chunk; per-draw info entries are accumulated into per-chain
    sums that survive resume (kept draws only, matching the reference's
    post-burn-in acceptance counting, src/rwmh.cpp:140-142). With ``mesh``,
    state (and keys) are sharded over the mesh's leading axis so the jitted
    chunk runs GSPMD-partitioned — checkpoint files always hold the gathered
    global state, so a run may resume on a different mesh.

    Calling :meth:`run` again with the same directory resumes from the last
    completed chunk and is bit-identical to an uninterrupted run
    (counter-based PRNG + deterministic kernels).
    """

    def __init__(self, step_batched, collect_fn, directory, mesh=None,
                 single_key=False):
        self.step = step_batched
        self.collect = collect_fn
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.mesh = mesh
        self.single_key = single_key
        self._compiled = None
        self._compiled_size = None

    def _chunk_fn(self, chunk_size):
        if self._compiled is None or self._compiled_size != chunk_size:
            self._compiled_size = chunk_size
            self._compiled = jax.jit(
                lambda keys, state: self._ragged(keys, state, chunk_size)
            )
        return self._compiled

    def _shard(self, keys, state):
        if self.mesh is None:
            return keys, state
        from mcmc_tpu.parallel.mesh import shard_chain_axis
        state = shard_chain_axis(state, self.mesh)
        if not self.single_key:
            keys = shard_chain_axis(keys, self.mesh)
        return keys, state

    def run(self, key, state0, n_draws, chunk_size=100, row_shape=None,
            dtype=None, n_burnin=0, max_chunks=None, track_moments=False,
            progress=False):
        """Returns ``(final_state, draws, info_totals)`` with draws memmapped
        from the sink and ``info_totals`` a dict of per-chain sums of every
        info entry over kept draws (``accepted`` being the acceptance count;
        divide by the kept-draw count for per-draw means — entries that are
        not counts or means, e.g. a step-size trace, produce sums with no
        standalone meaning and should be ignored by callers).
        ``n_burnin`` draws execute first without being stored.
        ``max_chunks`` stops after that many chunks (time-budgeted partial
        execution; call again to continue).

        ``track_moments=True`` folds every kept draw into streaming Welford
        moments (exact Chan-parallel merges, resume-safe inside the atomic
        checkpoint) and returns them under ``info_totals["moments"]`` as
        ``(count, mean, m2)`` — feed to
        :func:`mcmc_tpu.diagnostics.moments_finalize` /
        :func:`~mcmc_tpu.diagnostics.moments_rhat` for draw-free posterior
        estimates and R-hat on runs too long to load back.

        ``progress=True`` prints one status line per durable chunk
        (draws done / total, draws/s since start) to stderr; pass a
        callable instead to receive ``{"done", "total", "draws_per_s",
        "phase"}`` after each persisted chunk (host-side only — zero
        effect on the compiled pipeline)."""
        if self.single_key:
            keys = key
        else:
            n_chains = jax.tree_util.tree_leaves(state0)[0].shape[0]
            keys = jax.random.split(key, n_chains)
        state = state0
        total = n_burnin + n_draws

        # the sink stores exactly what collect() produces — deriving shape
        # AND dtype from it keeps float64 runs bit-exact (no silent f32 cast)
        sample = np.asarray(self.collect(state0))
        if row_shape is None:
            row_shape = tuple(sample.shape)
        if dtype is None:
            dtype = sample.dtype
        dtype_name = np.dtype(dtype).name

        ckpt = self.dir / "state.npz"
        meta_path = self.dir / "progress.json"    # human-readable mirror only
        sink_path = self.dir / "draws.bin"
        run_meta = {"n_draws": n_draws, "chunk_size": chunk_size,
                    "n_burnin": n_burnin, "dtype": dtype_name}

        done = 0
        totals = {}
        mom = None
        if ckpt.exists():
            try:
                (keys, state), meta, totals = _load_ckpt(ckpt, like=(keys, state))
                # chunk_size does not affect results (per-draw key/state
                # stream is carried in the checkpoint; chunking only moves
                # persistence boundaries — bit-identity is tested), and a
                # LARGER n_draws is a seamless continuation of the same
                # stream. Only n_burnin/dtype changes (or a shrunken total
                # below the completed count) force a restart — and that is
                # loud, never a silent discard of kept draws.
                compat = (meta.get("n_burnin") == n_burnin
                          and meta.get("dtype") == dtype_name
                          and meta.get("done", 0) <= total)
                if compat:
                    done = meta["done"]
                    if all(k in totals for k in _MOM_KEYS):
                        mom = [totals.pop(k) for k in _MOM_KEYS]
                else:
                    import warnings
                    warnings.warn(
                        f"checkpoint in {self.dir} is from a run with "
                        f"n_burnin={meta.get('n_burnin')}, "
                        f"dtype={meta.get('dtype')}, done={meta.get('done')} "
                        f"(this run: n_burnin={n_burnin}, dtype={dtype_name}, "
                        f"total={total}); restarting from scratch and "
                        f"discarding its kept draws")
                    keys = key if self.single_key else \
                        jax.random.split(key, n_chains)
                    state, totals = state0, {}
            except (ValueError, KeyError) as e:
                # stale checkpoint from an incompatible sampler-state
                # layout: restart rather than crash
                import warnings
                warnings.warn(f"ignoring incompatible checkpoint in "
                              f"{self.dir}: {e}")

        keys, state = self._shard(keys, state)
        run_chunk = self._chunk_fn(chunk_size)

        t_start, done_start = time.monotonic(), done
        mode_new = done == 0
        if mode_new and sink_path.exists():
            sink_path.unlink()

        # re-open sink in append mode by rewriting completed prefix
        kept_done = max(0, done - n_burnin)
        if not mode_new:
            existing = np.array(read_draws(sink_path, mmap=False)[:kept_done])
        else:
            existing = None

        if not track_moments:
            # do not carry (and re-persist) stale moments the caller is no
            # longer maintaining — they would silently miss this run's chunks
            mom = None
        elif mom is None and existing is not None and kept_done > 0:
            # resuming with track_moments newly enabled: fold the already
            # kept draws so streaming == batch over ALL kept draws
            mom = _merge_moments(None, existing)

        n_chunks = 0
        with DrawSink(sink_path, row_shape, dtype) as sink:
            if existing is not None:
                sink.append(existing)

            def persist(chunk):
                """Durably record one finished chunk (draws -> sink ->
                flush -> atomic state+progress+totals artifact). Blocks on
                the chunk's device arrays — by which time the NEXT chunk is
                already dispatched, so disk IO overlaps device compute."""
                nonlocal totals, mom
                if chunk["kept"]:
                    host_draws = np.asarray(chunk["draws"])
                    sink.append(host_draws)
                    if isinstance(chunk["infos"], dict):
                        totals = _sum_info(totals, chunk["infos"])
                    if track_moments:
                        mom = _merge_moments(mom, host_draws)
                # the native sink writes asynchronously: drain it before the
                # checkpoint claims these draws are durable; state + progress
                # + totals then land in ONE atomic artifact (no kill window
                # can leave them inconsistent)
                sink.flush()
                pers = dict(totals)
                if mom is not None:
                    pers.update(dict(zip(_MOM_KEYS, mom)))
                _save_ckpt(ckpt, _key_data((chunk["keys"], chunk["state"])),
                           {"done": chunk["done"], **run_meta}, pers)
                _atomic_write_text(meta_path, json.dumps(
                    {"done": chunk["done"], **run_meta,
                     "info_totals": {k: np.asarray(v).tolist()
                                     for k, v in totals.items()}}
                ))
                if progress:
                    elapsed = time.monotonic() - t_start
                    rate = (chunk["done"] - done_start) / max(elapsed, 1e-9)
                    info = {"done": chunk["done"], "total": total,
                            "draws_per_s": rate,
                            "phase": "keep" if chunk["kept"] else "burnin"}
                    if callable(progress):
                        progress(info)
                    else:
                        print(f"[ChunkedRunner] {info['phase']} "
                              f"{info['done']}/{total} draws "
                              f"({rate:.1f} draws/s)",
                              file=sys.stderr, flush=True)

            pending = None
            while done < total:
                if max_chunks is not None and n_chunks >= max_chunks:
                    break
                # chunks never straddle the burn-in/keep boundary
                if done < n_burnin:
                    step_n = min(chunk_size, n_burnin - done)
                else:
                    step_n = min(chunk_size, total - done)
                if step_n != chunk_size:
                    run_ragged = jax.jit(lambda k, s: self._ragged(k, s, step_n))
                    keys, state, draws, infos = run_ragged(keys, state)
                else:
                    keys, state, draws, infos = run_chunk(keys, state)
                # jax dispatch is asynchronous: the chunk above is now
                # queued on the device; schedule its D2H transfer to chase
                # it, then persist the PREVIOUS chunk while both run
                # (double-buffered pipeline). Burn-in draws are discarded by
                # persist, so only kept-phase chunks transfer their draws.
                if done >= n_burnin:
                    _start_host_copy((draws, infos))
                _start_host_copy((keys, state))  # checkpointed every chunk
                if pending is not None:
                    persist(pending)
                pending = {"keys": keys, "state": state, "draws": draws,
                           "infos": infos, "kept": done >= n_burnin,
                           "done": done + step_n}
                done += step_n
                n_chunks += 1
            if pending is not None:
                persist(pending)
        out_totals = dict(totals)
        if track_moments and mom is not None:
            # same pytree layout as diagnostics.moments_init
            out_totals["moments"] = {"count": mom[0], "mean": mom[1],
                                     "m2": mom[2]}
        return state, read_draws(sink_path), out_totals

    def _ragged(self, keys, state, length):
        if self.single_key:
            def body(carry, _):
                st, k = carry
                k, sub = jax.random.split(k)
                st, info = self.step(sub, st)
                return (st, k), (self.collect(st), info)
        else:
            def body(carry, _):
                st, ks = carry
                pairs = jax.vmap(lambda k: jax.random.split(k, 2))(ks)
                st, info = self.step(pairs[:, 1], st)
                return (st, pairs[:, 0]), (self.collect(st), info)
        (state, keys), (draws, infos) = jax.lax.scan(
            body, (state, keys), None, length=length
        )
        return keys, state, draws, infos
