"""repro_torch — the PyTorch/CUDA port of the LLMTailor reproduction.

It mirrors ``repro``'s layout (configs, data, models, optim, core,
checkpoint, kernels, launch), imports torch and never jax, and imports
nothing from ``repro``: it writes the same checkpoint bytes from its own
copies of the host layers.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``.
"""
