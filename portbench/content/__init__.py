"""The content of the requests: ``<name>.tar.zst``, a real file set
compressed whole, and ``<name>.json``, its source, size and SHA-256.
``build.py`` writes both from a Python install."""
