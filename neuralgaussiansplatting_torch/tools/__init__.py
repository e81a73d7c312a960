"""The port's tools: ``bench_scaling`` (the data-parallel step at world
sizes 1, 2 and 4), ``chain_bench`` (chained-iteration timing of the render
and training paths), ``exp_decode_proto`` (K6, the run-length decode),
``exp_mosaic_probe`` (K7, the idiom probes), ``make_demo_scene`` (a
Blender-layout dataset rendered by the port), and the full-schedule
quality harnesses ``train_quality_proof``, ``exp_quality_oracle``,
``train_neural_quality``, ``train_garden`` and ``bench_trained_scene``
(the JAX package's, around the port's entry points), the bench tools
``bench_suite`` and ``bench_garden`` and the stage timers
``exp_stage_micro``, ``exp_bwd_micro``, ``exp_neural_micro`` and
``exp_binning_micro`` (the JAX package's, chained eagerly; the root
``bench`` is ``python -m neuralgaussiansplatting_torch.bench``). Each runs
on the card with ``python -m neuralgaussiansplatting_torch.tools.<name>``."""
