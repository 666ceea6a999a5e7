"""Utilities of the port: the weight bridge from ``sige_tpu``
(``from_jax``), the reference-checkpoint converters (``convert``,
``convert_sd``), native checkpoints (``checkpoint``), EMA, the config
reader, the HTML gallery and the invisible watermark."""
