"""Host C++ data plane (xxh64 digests, hashed pwrite/pread), built with
g++ on first use by :mod:`.build`."""
