"""Helpers of the port that need no torch: the JAX-params converter
(``torch_compat``, numpy only) and ``generate.main``'s file writers
(``html``)."""
