"""Mamba2's decode recurrence as a hand-written kernel
(:func:`repro_torch.kernels.ssm.mamba2_step.mamba2_step`)."""
