"""Pytree parameter front-end: structured models on the flat-vector API.

The sampler entry points speak flat parameter vectors — the reference's
``ColVec_t`` convention (reference include/mcmc/rwmh.hpp:41-87), which is
also what the kernels want on an accelerator (one contiguous ``(chains, d)`` batch).
Real models have structure: ``{"mu": (k,), "L": (k, k), "sigma": ()}``.
This module bridges the two with :func:`jax.flatten_util.ravel_pytree`:

    x0, log_kernel, unravel = ravel_model(init_tree, tree_log_kernel)
    out = mcmc_tpu.nuts(x0, log_kernel, ...)
    tree_draws = unravel_draws(out.draws, unravel)   # same structure,
                                                     # leading draw axes

The flatten/unflatten pair is a trace-time reshape — XLA fuses it away,
so the structured view costs nothing at run time.

Box constraints compose positionally: ``bounds_like(init_tree, tree)``
builds the flat ``lower_bounds``/``upper_bounds`` vectors from a pytree
(or prefix thereof) of per-leaf bounds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

__all__ = ["ravel_model", "unravel_draws", "bounds_like",
           "coerce_model"]


def ravel_model(init_tree, tree_log_kernel=None):
    """Flatten a pytree-parameterized model onto the sampler API.

    Returns ``(x0, log_kernel, unravel)``: ``x0`` the flat initial vector,
    ``log_kernel(x) -> scalar`` evaluating ``tree_log_kernel`` on the
    unflattened tree (``None`` if no kernel given — useful for samplers
    with a different callback contract, e.g. ``elliptical_slice`` or
    ``sgld``: wrap each callback with ``lambda x, *a: f(unravel(x), *a)``),
    and ``unravel(x) -> tree``.
    """
    x0, unravel = ravel_pytree(init_tree)
    if x0.ndim != 1:
        raise ValueError("init_tree must contain at least one array leaf")
    if tree_log_kernel is None:
        return x0, None, unravel
    if not callable(tree_log_kernel):
        raise TypeError("tree_log_kernel must be callable: "
                        "tree_log_kernel(params_tree) -> scalar")

    def log_kernel(x):
        return tree_log_kernel(unravel(x))

    return x0, log_kernel, unravel


def unravel_draws(draws, unravel):
    """Unflatten sampler draws back into parameter structure.

    ``draws`` is ``(..., d)`` — any number of leading draw/chain axes;
    returns the pytree of ``unravel`` with each leaf carrying those
    leading axes. vmapped over the leading axes, so it stays one fused
    XLA program (no per-draw Python loop).
    """
    draws = jnp.asarray(draws)
    f = unravel
    for _ in range(draws.ndim - 1):
        f = jax.vmap(f)
    return f(draws)


def bounds_like(init_tree, bound_tree, default):
    """Flat per-dimension bounds vector from a pytree of per-leaf bounds.

    ``bound_tree`` is a pytree prefix of ``init_tree``: each entry is a
    scalar (applied to every element of the matching leaf/subtree), an
    array broadcastable to the leaf, or ``None`` (unbounded —
    ``default``, which callers pass as ``-inf``/``+inf``). Returns the
    flat vector aligned with :func:`ravel_model`'s ``x0``.
    """
    leaves, treedef = jax.tree_util.tree_flatten(init_tree)
    try:
        bounds = treedef.flatten_up_to(bound_tree)
    except ValueError as e:
        raise ValueError(
            f"bound_tree must be a pytree prefix of init_tree: {e}") from e
    flat = []
    for leaf, b in zip(leaves, bounds):
        leaf = jnp.asarray(leaf)
        val = default if b is None else b
        flat.append(jnp.broadcast_to(
            jnp.asarray(val, leaf.dtype), leaf.shape).ravel())
    return jnp.concatenate(flat) if flat else jnp.zeros((0,))


def coerce_model(initial_vals, *fns):
    """Accept flat-vector OR pytree initial values uniformly.

    Returns ``(x0, wrapped_fns, unravel)``: flat inputs pass through with
    ``unravel=None``; a dict (or anything :func:`jnp.asarray` rejects)
    ravels through :func:`ravel_model`, and every function in ``fns`` is
    wrapped to take the flat vector. The ergonomic bridge used by the
    approximate-inference surfaces (pathfinder/advi/svgd/map_laplace/
    thermo_evidence) — samplers go through ``fit``'s richer path, which
    also maps bound trees.
    """
    is_tree = isinstance(initial_vals, dict)
    if not is_tree and not (callable(initial_vals)
                            and not hasattr(initial_vals, "__array__")):
        try:
            jnp.asarray(initial_vals)
        except (TypeError, ValueError):
            is_tree = True
    if not is_tree:
        return initial_vals, fns, None
    x0, unravel = ravel_pytree(initial_vals)
    wrapped = tuple((lambda f: lambda x, *a: f(unravel(x), *a))(f)
                    for f in fns)
    return x0, wrapped, unravel
