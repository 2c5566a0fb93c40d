"""A decode step's attention over the ring KV cache as a hand-written kernel
(:func:`repro_torch.kernels.attention.decode_attention.decode_attention`)."""
