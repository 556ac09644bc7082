"""Experiment configurations: the paper's matmul sizes (``paper_mm``) and
the models of the dense-attention family (``registry.get_config``)."""
