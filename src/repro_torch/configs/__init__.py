"""Experiment configurations: the paper's matmul sizes (``paper_mm``) and
the reference's ten model architectures (``registry.get_config``)."""
