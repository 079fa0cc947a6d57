"""Extraction rate of the evaluation window: images embedded over the
harness's spans around each ``FeatureExtractor.extract`` call (ended by the
host copy of its result), in img/s."""


def read(run):
    s = run.spans.get("extract")
    if not s:
        return None
    return run.counts["images"] / s
