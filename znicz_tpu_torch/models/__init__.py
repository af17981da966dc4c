"""Model builders of the port: the reference's zoo, one module a model,
each exposing its builder(s) and ``run(load, main)`` for ``python -m
znicz_tpu_torch <models/name.py>`` (``char_lm`` the transformer LM)."""
