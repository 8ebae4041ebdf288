"""lstpu-check for the PyTorch port: the static analysis suite, run on the
port's own tree (``langstream_tpu_torch/``).

The port's serving core is a multi-threaded engine whose correctness rests
on the hand-kept rules of the JAX package it mirrors: counters mutate only
under their annotated lock, flight dumps / beacons / wire frames never
carry token content, every fault site / dump reason / knob / gauge stays
in sync with its drill, Grafana panel and docs, and every thread says
whether it is a daemon and has a join. It adds one rule of its own: a
captured decode or verify chunk (a CUDA graph) never syncs the host, never
builds a tensor from a Python value, and never rebinds a buffer the graphs
hold. The passes:

- ``core``            shared visitor/reporting frame: file discovery under
                      ``langstream_tpu_torch/``, parent-annotated ASTs,
                      ``# lstpu: ignore[CODE]`` suppressions, the port's
                      baseline (``analysis/baseline.json``)
- ``locks``           LSA1xx lock discipline (the ``_GUARDED`` class
                      registry convention)
- ``redaction``       LSA2xx redaction taint (dump extras, span
                      attributes, beacons, wire frames)
- ``compile_surface`` LSA3xx capture surface: the registry of CUDA-graph
                      sites and captured bodies, host work reached from a
                      captured body, and rebinding a captured buffer
- ``registry_drift``  LSA4xx registry drift (fault sites, dump reasons,
                      the provider's knobs, gauges vs the port's tests /
                      docs / dashboards)
- ``threads``         LSA5xx thread-shutdown hygiene (explicit
                      ``daemon=``, reachable join on the close path)
- ``lockorder``       the RUNTIME companion: a lock-order recorder that
                      wraps the locks made in ``langstream_tpu_torch``
                      frames and reports acquisition cycles

Run ``python -m langstream_tpu_torch.analysis --strict``. The package
imports the stdlib only — no torch, no jax, nothing of ``langstream_tpu``:
the suite parses source, it never executes it.
"""

from langstream_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    Repo,
    all_checkers,
    run_checks,
)
