"""Entry points: ``launch/serve.py`` (LM and retrieval modes), ``launch/mesh.py``
(meshes of ranks and ``spawn``) and ``launch/apss_mesh.py`` (the distributions'
variants run per rank)."""
