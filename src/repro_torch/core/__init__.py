"""SLING core, ported to PyTorch: plan, Alg-4 walks, Alg-2 HP build,
index, single-source and top-k queries."""
