"""Operations and bytes from a configuration's shapes, one module per
architecture: ``flops_per_frame(cfg)`` counts 2 per multiply-accumulate
of every convolution and matrix product (attention's two products
included) and no elementwise work; ``kernel_costs(cfg, batch)`` gives
(operations, bytes) of one launch of each hand-written kernel the window
runs, each input byte read once and each output byte written once."""
