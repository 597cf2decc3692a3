"""Entry points that check, time and tune the port's kernels, the
counterparts of the JAX package's ``scripts/check_fused_objective.py``,
``scripts/time_fused_objective.py`` and ``scripts/tune_bfgs_kernel.py``.
Each runs as ``python -m davo_tpu_torch.scripts.<name>`` on the card, or is
called as ``main(device="cpu", batch=...)`` to run its plain versions on
the CPU (control flow only: no time is read there).  ``time_orbax_reads``
times the Orbax reader on the repo's stores, host code with no device.
"""
