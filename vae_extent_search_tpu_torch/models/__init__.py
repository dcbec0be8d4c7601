"""Model layers of the port: dense MLPs, the VAE, the cost predictor, the
GBDT cost models, the per-store segment models and the LSTM / MHA /
TabNet sequence models."""


def load_model_pickle(path: str, device="cuda"):
    """Load ANY saved cost-model internal by sniffing the pickle blob: the
    eval scripts take a model file of whatever family train_model
    produced. Tree internals pickle themselves; the segment models save
    dict blobs distinguished by their keys (the JAX package's layout, so
    its MLP, SegmentVAE and sequence-model pickles load here too) and
    are placed on ``device``."""
    import pickle

    with open(path, "rb") as f:
        blob = pickle.load(f)
    if not isinstance(blob, dict):
        return blob                    # pickled internal (GBDT/LGB)
    if "vae_params" in blob:
        from .segment import SegmentVAEModelInternal

        return SegmentVAEModelInternal.load(path, device=device)
    if "arch" in blob:
        from .variants import SequenceModelInternal

        return SequenceModelInternal.load(path, device=device)
    from .segment import MLPModelInternal

    return MLPModelInternal.load(path, device=device)
