"""The committed featurized candidate pool."""
