"""Developer tools of the PyTorch/CUDA port, run as ``python -m
nnstreamer_tpu_torch.tools.<name>`` (console scripts in pyproject
``[project.scripts]``): the element-doc generator, the pipeline ⇄ pbtxt
converter and the custom-filter scaffold generator.

Counterparts of the JAX package's ``tools/`` (parity: the reference's
``tools/development/`` code generator and pipeline parser).
"""
