"""Entry points: ``launch/serve.py`` (LM and retrieval modes)."""
