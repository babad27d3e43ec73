"""The laws of the synthetic corpora, one module a law, found by the name
in a configuration's ``assumed.law``: ``draw(config, gen)`` returns the
corpus as ``apssbench.gen.Csr`` on ``gen``'s device."""
