"""The program's side of each architecture: how the weights the benchmark
made become a model registered with the program, the hand-written
kernels it runs (``KERNELS``), the pipeline that runs it, and what a
window's result at the sink holds.  Besides these, only the harness and
the sources touch the program: ``parse_launch``, the sources' and sinks'
buffers, the kernel build and ``unregister_model``."""
