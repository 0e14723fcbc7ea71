"""mpctsid_tpu_torch — the PyTorch/CUDA port of the MPC + TSID quadruped engine.

A second package beside ``mpctsid_tpu`` (the JAX reference, which it never
imports).  Same directory layout and function names, so a reader finds each
counterpart; PyTorch idiom inside:

  * every public function takes tensors with a LEADING SCENARIO AXIS (B, ...);
    a single robot is a batch of one.  What the JAX package reaches through
    ``jax.vmap`` is written out here.
  * ``lax.scan`` / ``fori_loop`` are Python loops; all contact and failure
    switching stays masked arithmetic, so the tick loop never syncs the host.
  * entry points take ``device=`` and default to ``"cuda"``; they raise when
    CUDA is asked for and absent.  Nothing silently continues on the CPU.
  * matrix products run in full float32 (utils.enforce_f32_matmuls).

Layout:
  model/    Solo-12 parameters, gait tables, kinematic tree (numpy data)
  dyn/      batched rigid-body dynamics: FK, Jacobians, CRBA, RNEA
  plan/     gait tables, Raibert footsteps, swing polynomials; the footstep
            horizon and the swing reference (and mpc/'s reference rollout)
            as hand-written CUDA kernels (plan/kernels.py, plan/csrc/)
  qp/       batched dense ADMM QP core, blocked SPD inverse, the five TPU
            kernels, kernels A and B and Ruiz as hand-written CUDA kernels
            (qp/kernels.py, qp/csrc/)
  mpc/      SRB discretization + condensation -> qp/
  wbc/      TSID-style task assembly -> qp/
  env/      batched penalty-contact plant; the host-side Plant protocol
  est/      complementary-filter state estimator
  oracle/   the float64 numpy reference (a copy of the JAX package's; no
            torch): the parity target of the contract's 1e-4
  cascade/  the closed-loop cascade: cascade_period / cascade_rollout (the
            eager reference) and cascade_rollout_graphed (one CUDA graph
            per period, replayed: what run, sweep and dist/ call)
  interop   numpy <-> state dataclasses (carrying a state across packages)
  run       CLI entry point: one closed-loop run
  sweep     CLI entry point: Monte-Carlo scenario sweeps with checkpoints
"""

from mpctsid_tpu_torch.utils import enforce_f32_matmuls

__version__ = "0.1.0"

enforce_f32_matmuls()
