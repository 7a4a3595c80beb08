"""Debug-mode NaN/inf tripwires for jitted SLAM programs.

The reference has no sanitizer infrastructure at all — its nodes are
single-threaded C++ and ``-Wall -Wextra`` is the only hygiene
(ref rigid2d/CMakeLists.txt:142; SURVEY.md §5 sanitizers row). The failure
class that motivates a tripwire HERE is real and accelerator-specific: f32
conditioning cliffs at 50k-landmark scale NaN'd production stage-2 runs
(BENCH_NOTES pathologies 6-7), and inside ``jit`` a NaN propagates silently
through every downstream tick. These helpers wrap any step with
``jax.experimental.checkify`` user checks so a debug run *names* the first
non-finite field and fails loudly, while the production path (un-wrapped)
pays zero cost.

Usage::

    err, out = checked(my_tick)(state, ...)   # jit-compatible
    err.throw()                               # raises with the field name

or for the pipeline driver, :func:`run_scenario_checked` mirrors
``pipeline.driver.run_scenario`` with per-tick mean/cov checks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import checkify


def check_finite(tree, name: str = "state") -> None:
    """Emit a ``checkify.check`` that every floating leaf of ``tree`` is
    finite. Must be called inside a function wrapped by :func:`checked`
    (or ``checkify.checkify``); a plain call outside checkify raises."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        leaf = jnp.asarray(leaf)
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            label = name + jax.tree_util.keystr(path)
            checkify.check(jnp.all(jnp.isfinite(leaf)),
                           f"non-finite values in {label}")


def checked(fn):
    """Wrap ``fn`` (which may call :func:`check_finite`) into a
    functionalized ``(err, out) = wrapped(*args)`` form that composes with
    ``jit``/``scan``/``shard_map``. Caller decides when to ``err.throw()``."""
    return checkify.checkify(fn, errors=checkify.user_checks)


def run_scenario_checked(scn, key, dtype=jnp.float32):
    """``pipeline.driver.run_scenario`` with a per-tick NaN/inf tripwire on
    the EKF mean and covariance (and the odometry/truth poses). Returns the
    stacked TickOutputs; raises ``checkify.JaxRuntimeError`` naming the bad
    field if any tick goes non-finite.

    ~2x slower than the raw scenario (checkify threads error state through
    the scan) — a debug tool, not the production entry.
    """
    from ..pipeline import driver

    def fn(key):
        params = scn.world_params(dtype)
        Q, R = scn.noise_matrices(dtype)
        state = driver.init_pipeline(scn, dtype)._replace(key=key)
        cmds = driver.command_twist(scn, jnp.arange(scn.steps), dtype)

        def body(st, cmd):
            st, out = driver.slam_tick(scn, params, Q, R, st, cmd)
            check_finite(st.filt.mean, "ekf.mean")
            check_finite(st.filt.cov, "ekf.cov")
            check_finite(out.odom_pose, "odom.pose")
            return st, out

        _, outs = jax.lax.scan(body, state, cmds)
        return outs

    err, outs = jax.jit(checked(fn))(key)
    err.throw()
    return outs


def checked_blocked_tick(step):
    """Wrap a blocked-EKF sharded step (``step(state, tw, zs, valid, [ids,]
    Q, R) -> state``) with a post-step finiteness tripwire over the whole
    BlockedState. Returns ``wrapped(*args) -> (err, state)``."""

    @functools.wraps(step)
    def tick(*args):
        st = step(*args)
        check_finite(st, "blocked")
        return st

    return checked(tick)
