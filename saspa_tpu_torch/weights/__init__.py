"""Public checkpoint files -> the port's models (counterpart of
tools/convert_weights.py and tools/weights_day.py): `files` reads them,
`sources` finds them in a --weights_dir tree, `convert` maps their keys to
flax-shaped trees, `load` loads those into the models strictly."""
