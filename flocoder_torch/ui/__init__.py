"""The sampler's web UI (``webapp.py``), served on the Python standard
library."""
