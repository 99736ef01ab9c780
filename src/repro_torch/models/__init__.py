"""The LM decoder models of ``repro.models`` in PyTorch: layers, attention
(GQA, MLA, cross-attention), Mixture-of-Experts, the Mamba-2 SSD block and
the assembled :class:`~repro_torch.models.transformer.Model`. Each function
keeps its reference's name and computes what it computes, in its
precision; parameters and caches are nested dicts of tensors with the
reference's tree paths."""
