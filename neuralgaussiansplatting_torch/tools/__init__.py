"""The port's tools: ``chain_bench`` (chained-iteration timing of the render
and training paths), ``exp_decode_proto`` (K6, the run-length decode),
``exp_mosaic_probe`` (K7, the idiom probes) and ``make_demo_scene`` (a
Blender-layout dataset rendered by the port). Each runs on the card with
``python -m neuralgaussiansplatting_torch.tools.<name>``."""
