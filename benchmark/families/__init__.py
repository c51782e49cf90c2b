"""One module a model family, found by a configuration's "family" key:
`model_config(cfg)` (the port's ModelConfig), `draw(cfg, draw)` (the
base's weights from the seed, a dict of plain tensors the reference reads
too), `port_params(w)` (the port's params over those same tensors) and
`draft(cfg, draw, w)` (the draft the port serves with)."""
