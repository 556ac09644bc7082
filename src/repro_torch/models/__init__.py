"""The LM stack of the dense-attention family: configs, layers,
attention, FFN and the assembled model (the port of ``repro.models``)."""
