"""The LM model zoo's serving path (prefill + decode) in PyTorch.

Ported so far: GQA attention, the dense SwiGLU MLP, Mamba-2, the block
tokens ``m``, ``a`` and ``A`` and the decoder-only LM assembly — what
zamba2-7b runs.  :func:`repro_torch.models.model.build_model` is the entry.
"""
