"""The index substrate: dictionaries, streams, posting codecs, the
updatable inverted indexes and the (sharded) index sets.  A copy of the
reference ``repro.core`` modules the search path needs, importing only
``repro_torch``."""
