"""Device decode batches a request takes (spans inflate.batch): a
request's streams without a TZ index decode one by one, a batch each."""

from benchmark import readers, spans


def read(rec):
    return spans.count(rec, "inflate.batch", readers.DECODE)
