"""How frames enter the pipeline, one module a kind of source, named by
a traffic file's ``source`` key.  Each module defines:

- ``head(traffic)``: the pipeline's first element, named ``src``;
- ``attach(p, frames, traffic)``: hands the pool's host windows to the
  built pipeline ``p`` before it starts; returns None, or, for a source
  that runs a thread of its own, the callable that stops it."""
