"""MB (2**20 bytes) of the server's caches and plan (the engine state's
storages, each counted once) per session."""


def read(rec):
    if not rec.cache_bytes:
        return None
    return rec.cache_bytes / rec.sessions / 2**20
