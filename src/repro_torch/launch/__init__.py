"""Entry points: ``launch/serve.py`` (retrieval mode)."""
