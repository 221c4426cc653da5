"""Model core: layers, attention, blocks, model, paged cache and steps."""
