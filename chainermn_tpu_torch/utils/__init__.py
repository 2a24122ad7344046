"""Host utilities: the native data-loader core (:mod:`.native`)."""
