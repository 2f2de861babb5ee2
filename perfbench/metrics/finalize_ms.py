"""Host ms a batch of ``BucketServer.finalize`` (fetch and doc-id map),
timed untraced, each once its batch's device work has finished."""


def read(w):
    return sum(w.finalize_s) * 1e3 / len(w.finalize_s) if w.finalize_s \
        else None
