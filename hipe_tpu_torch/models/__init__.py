"""Filter pipelines — the deployable "models" of the engine."""
