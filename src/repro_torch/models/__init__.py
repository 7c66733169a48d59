"""The language-model stack of the port: layers, GQA attention, MoE,
the Mamba mixer, blocks and the model (train forward)."""
