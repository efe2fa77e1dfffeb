"""Port of ``repro/launch``: the demo sampling launcher."""
