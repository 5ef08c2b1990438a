"""The kernel lab (port of `tinypathtracer_tpu/tools`): harnesses that
time the intersectors and kernels on the card. Each is a module with a
`main(argv)`, run as `python -m tinypathtracer_tpu_torch.tools.<name>`;
`--device cuda` (the default) or `--device cpu` (the plain twins, for
tests at tiny sizes)."""
