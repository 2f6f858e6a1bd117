"""Stored bytes per plaintext byte, x 100, over every stream the window
wrote that the reference restored to its object."""


def read(rec):
    w = rec["window"]
    if rec["entry"] != "compress_many" or not w["stored_plain_bytes"]:
        return None
    return 100.0 * w["stored_bytes"] / w["stored_plain_bytes"]
