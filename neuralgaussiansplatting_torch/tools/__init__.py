"""The port's tools: ``chain_bench`` (chained-iteration timing of the render
and training paths), ``exp_decode_proto`` (K6, the run-length decode) and
``exp_mosaic_probe`` (K7, the idiom probes). Each runs on the card with
``python -m neuralgaussiansplatting_torch.tools.<name>``."""
