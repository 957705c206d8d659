"""Model configurations: the reference's ten architectures and their
smoke twins (``registry.get``)."""
