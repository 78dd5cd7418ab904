"""Architecture shape tables (copies of ``repro/configs``): ``registry``
maps ``--arch`` ids to a ``ModelConfig`` and its smoke config; ``shapes``
holds the assigned input shapes."""
