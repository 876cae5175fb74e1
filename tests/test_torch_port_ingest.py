"""The port's ingestion (``pmgt_tpu_torch/data/ingest.py``) against the
JAX package's, with a fake ``urlopen`` (no network): the dump download
(URL, streamed file, idempotence, the source sidecar), the image-URL
parser on the metadata field variants, and the image scraper's retries,
exponential backoff and giving up, as ``tests/test_ingest.py`` holds the
JAX package's. Also the ``scrape-images`` command."""
import gzip
import io
import json
import os

import pytest

from pmgt_tpu.data import ingest as jingest
from pmgt_tpu_torch.cli.main import main
from pmgt_tpu_torch.data import ingest as tingest


class _Resp(io.BytesIO):
    """urllib-response stand-in (context manager + read)."""


@pytest.mark.parametrize("name,stem", [("VG", "Video_Games"), ("TG", "Toys_and_Games"),
                                       ("Beauty", "Beauty")])
def test_download_reviews_same_url_and_file(tmp_path, name, stem):
    payload = gzip.compress(b'{"reviewerID": "u", "asin": "A"}\n')
    seen = {}
    for pkg in (jingest, tingest):
        urls = seen.setdefault(pkg.__name__, [])

        def opener(url, **kw):
            urls.append(url)
            return _Resp(payload)

        d = tmp_path / pkg.__name__
        out = pkg.download_reviews(name, str(d), opener=opener)
        assert open(out, "rb").read() == payload
        pkg.download_reviews(name, str(d), opener=opener)  # idempotent
        assert len(urls) == 1
        assert (d / "reviews.json.gz.source").read_text() == urls[0]
    assert seen["pmgt_tpu.data.ingest"] == seen["pmgt_tpu_torch.data.ingest"] == [
        f"http://deepyeti.ucsd.edu/jianmo/amazon/categoryFilesSmall/{stem}_5.json.gz"]


def test_download_reviews_refuses_another_datasets_dump(tmp_path):
    def opener(url, **kw):
        return _Resp(b"x")

    tingest.download_reviews("VG", str(tmp_path), opener=opener)
    with pytest.raises(ValueError, match="separate raw dir"):
        tingest.download_reviews("TG", str(tmp_path), opener=opener)


def _meta(tmp_path, gz=False):
    rows = [
        json.dumps({"asin": "A", "imUrl": "http://x/a.jpg"}),
        json.dumps({"asin": "B", "imageURLHighRes": ["http://x/b1.png", "http://x/b2.png"],
                    "imageURL": ["http://x/low.png"]}),
        json.dumps({"asin": "C"}),
        json.dumps({"asin": "D", "imageURL": ["", 3, "http://x/d.gif?sz=1"]}),
        json.dumps({"imUrl": "http://x/noasin.jpg"}),
        "not json",
        "",
    ]
    path = tmp_path / ("meta.json.gz" if gz else "meta.json")
    data = "\n".join(rows).encode()
    path.write_bytes(gzip.compress(data) if gz else data)
    return str(path)


@pytest.mark.parametrize("gz", [False, True])
def test_load_image_urls_equals_the_jax_parser(tmp_path, gz):
    path = _meta(tmp_path, gz)
    got = tingest.load_image_urls(path)
    assert got == jingest.load_image_urls(path)
    assert got == {"A": ["http://x/a.jpg"], "B": ["http://x/b1.png", "http://x/b2.png"],
                   "D": ["http://x/d.gif?sz=1"]}


def test_scrape_images_retries_with_backoff(tmp_path):
    """The first two fetches of each URL fail; the waits are exponential
    and every image lands, in both packages alike."""
    results = {}
    for pkg in (jingest, tingest):
        attempts, waits = {}, []

        def opener(url, **kw):
            attempts[url] = attempts.get(url, 0) + 1
            if attempts[url] <= 2:
                raise OSError("transient")
            return _Resp(b"IMGDATA" + url.encode())

        d = tmp_path / pkg.__name__
        counts = pkg.scrape_images(
            {"A": ["http://x/a.jpg"], "B": ["http://x/b.png", "http://x/b.webp?x=1"]},
            str(d), max_workers=1, max_retries=4, backoff=0.5, opener=opener,
            sleep=waits.append)
        files = sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())
        results[pkg.__name__] = (counts, sorted(waits), files)
        assert (d / "A" / "0.jpg").read_bytes() == b"IMGDATAhttp://x/a.jpg"
    t = results["pmgt_tpu_torch.data.ingest"]
    assert t == results["pmgt_tpu.data.ingest"]
    assert t[0] == (3, 0) and t[1] == [0.5, 0.5, 0.5, 1.0, 1.0, 1.0]
    assert t[2] == ["A/0.jpg", "B/0.png", "B/1.webp"]


def test_scrape_images_gives_up_and_skips_present_files(tmp_path):
    calls = []

    def down(url, **kw):
        calls.append(url)
        raise OSError("down")

    waits = []
    assert tingest.scrape_images({"A": ["http://x/a.jpg"]}, str(tmp_path), max_retries=3,
                                 backoff=0.1, opener=down, sleep=waits.append) == (0, 1)
    assert len(calls) == 3 and waits == [0.1, 0.2]
    assert not list((tmp_path / "A").iterdir())  # no partial file
    (tmp_path / "A" / "0.jpg").write_bytes(b"old")
    assert tingest.scrape_images({"A": ["http://x/a.jpg"]}, str(tmp_path),
                                 opener=down, sleep=waits.append) == (1, 0)
    assert len(calls) == 3


def test_scrape_images_command(tmp_path, monkeypatch):
    """``scrape-images`` parses the metadata and scrapes with its options
    (the scraper's opener replaced: no network)."""
    got = {}

    def fake_scrape(urls, image_dir, **kw):
        got.update(urls=urls, image_dir=image_dir, **kw)
        return len(urls), 0

    monkeypatch.setattr(tingest, "scrape_images", fake_scrape)
    path = _meta(tmp_path)
    out = main(["scrape-images", "--meta-path", path, "--image-dir", str(tmp_path / "img"),
                "--max-workers", "3", "--backoff", "0.25"])
    assert out == (3, 0)
    assert got == {"urls": tingest.load_image_urls(path), "image_dir": str(tmp_path / "img"),
                   "max_workers": 3, "max_retries": 4, "backoff": 0.25}
    with pytest.raises(SystemExit):
        main(["scrape-images", "--meta-path", str(tmp_path / "absent.json"),
              "--image-dir", str(tmp_path)])
