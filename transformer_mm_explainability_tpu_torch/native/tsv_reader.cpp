// Fast base64-TSV object-feature reader (C++).
//
// The port's copy of ``transformer_mm_explainability_tpu/native/
// tsv_reader.cpp``, with two additions so that a record read here equals
// the one ``data/vqa.load_obj_tsv`` parses in Python: each record keeps its
// attribute ids and confidences (``tsv_get_attrs``), and ``tsv_num_boxes``
// tells the caller how many boxes a record holds before it sizes buffers.
//
// Native data-loader for the bottom-up-attention interchange format
// consumed by the LXMERT pipeline (lxmert/src/utils.py load_obj_tsv):
// tab-separated rows of
//   img_id  img_h  img_w  objects_id  objects_conf  attrs_id
//   attrs_conf  num_boxes  boxes(b64 f32[n,4])  features(b64 f32[n,D])
//
// The python csv + base64 path spends most of its time in row splitting
// and temporary buffers; this parser streams the file once and decodes
// base64 straight into caller-provided float buffers. Exposed as a
// plain C ABI for ctypes.

#include <algorithm>
#include <atomic>
#ifdef __GLIBC__
#include <malloc.h>
#endif
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

int8_t kB64Inv[256];

struct InitB64 {
  InitB64() {
    std::memset(kB64Inv, -1, sizeof(kB64Inv));
    const char* alphabet =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    for (int i = 0; i < 64; ++i) kB64Inv[(uint8_t)alphabet[i]] = i;
  }
} kInit;

// decode base64 `in[0..len)` into `out`, returns bytes written (-1 on error)
int64_t b64_decode(const char* in, int64_t len, uint8_t* out,
                   int64_t out_cap) {
  while (len > 0 && (in[len - 1] == '=' || in[len - 1] == '\n' ||
                     in[len - 1] == '\r'))
    --len;
  int64_t w = 0;
  int acc = 0, bits = 0;
  for (int64_t i = 0; i < len; ++i) {
    const int8_t v = kB64Inv[(uint8_t)in[i]];
    if (v < 0) return -1;
    acc = (acc << 6) | v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      if (w >= out_cap) return -1;
      out[w++] = (uint8_t)((acc >> bits) & 0xFF);
    }
  }
  return w;
}

struct Record {
  std::string img_id;
  int img_h = 0, img_w = 0, num_boxes = 0;
  std::vector<float> boxes;     // [n, 4]
  std::vector<float> features;  // [n, D]
  std::vector<int64_t> objects_id;
  std::vector<float> objects_conf;
  std::vector<int64_t> attrs_id;
  std::vector<float> attrs_conf;
};

struct Store {
  std::vector<Record> records;
  int feat_dim = 0;
};

std::vector<Store*> g_stores;

}  // namespace

extern "C" {

namespace {

// Parse one TSV row (without trailing newline) into `rec`.
// Returns the per-record feature dim, or -1 if the row is malformed.
// Strict size validation: the decoded payloads must agree with
// num_boxes, or the row is dropped — tsv_get memcpys n*feat_dim
// floats from these buffers, so a short decode would otherwise read
// out of bounds.
int parse_row(const char* p, const char* end, Record* rec,
              std::vector<uint8_t>& scratch) {
  const char* fields[10];
  int64_t lens[10];
  int nf = 0;
  while (nf < 10) {
    const char* tab = (const char*)memchr(p, '\t', end - p);
    fields[nf] = p;
    lens[nf] = (tab ? tab : end) - p;
    ++nf;
    if (!tab) break;
    p = tab + 1;
  }
  if (nf < 10) return -1;  // malformed row

  rec->img_id.assign(fields[0], lens[0]);
  rec->img_h = atoi(std::string(fields[1], lens[1]).c_str());
  rec->img_w = atoi(std::string(fields[2], lens[2]).c_str());
  rec->num_boxes = atoi(std::string(fields[7], lens[7]).c_str());
  const int n = rec->num_boxes;

  auto decode_floats = [&](int fi, std::vector<float>* out) -> bool {
    scratch.resize((lens[fi] / 4 + 1) * 3);
    int64_t nb = b64_decode(fields[fi], lens[fi], scratch.data(),
                            (int64_t)scratch.size());
    if (nb < 0) return false;
    out->resize(nb / sizeof(float));
    std::memcpy(out->data(), scratch.data(), nb);
    return true;
  };
  auto decode_i64 = [&](int fi, std::vector<int64_t>* out) -> bool {
    scratch.resize((lens[fi] / 4 + 1) * 3);
    int64_t nb = b64_decode(fields[fi], lens[fi], scratch.data(),
                            (int64_t)scratch.size());
    if (nb < 0) return false;
    out->resize(nb / sizeof(int64_t));
    std::memcpy(out->data(), scratch.data(), nb);
    return true;
  };
  if (n <= 0) return -1;
  if (!decode_i64(3, &rec->objects_id)) return -1;
  if (!decode_floats(4, &rec->objects_conf)) return -1;
  // the attribute fields do not decide whether a row is valid (the JAX
  // reader does not read them): a payload that does not decode is empty
  if (!decode_i64(5, &rec->attrs_id)) rec->attrs_id.clear();
  if (!decode_floats(6, &rec->attrs_conf)) rec->attrs_conf.clear();
  if (!decode_floats(8, &rec->boxes)) return -1;
  if (!decode_floats(9, &rec->features)) return -1;
  if (rec->boxes.size() != (size_t)n * 4) return -1;
  if (rec->features.size() % (size_t)n != 0) return -1;
  const int d = (int)(rec->features.size() / (size_t)n);
  return d > 0 ? d : -1;
}

}  // namespace


namespace {
// Pick the majority feature dim across parsed rows and keep only rows
// of that dim (warning on stderr about drops). Guards against "first
// valid row poisoning": a corrupt/truncated first row whose payload
// happens to divide num_boxes would otherwise set feat_dim wrong and
// silently drop every genuine row.
void finalize_rows(std::vector<std::pair<int, Record>>* rows,
                   int64_t topk, Store* store) {
  std::map<int, size_t> dim_counts;
  for (const auto& pr : *rows)
    if (pr.first > 0) dim_counts[pr.first]++;
  int best_dim = 0;
  size_t best_n = 0;
  for (const auto& kv : dim_counts)
    if (kv.second > best_n) { best_n = kv.second; best_dim = kv.first; }
  store->feat_dim = best_dim;
  size_t dropped = 0;
  for (auto& pr : *rows) {
    if (topk >= 0 && (int64_t)store->records.size() >= topk) break;
    if (pr.first != best_dim) { if (pr.first > 0) dropped++; continue; }
    store->records.push_back(std::move(pr.second));
  }
  if (dropped) {
    std::fprintf(stderr,
                 "[tsv_reader] warning: dropped %zu rows whose feature "
                 "dim != majority dim %d\n", dropped, best_dim);
  }
}
}  // namespace

// Parse the file; returns a handle (>= 0) or -1 on failure.
// topk < 0 → everything.
int64_t tsv_open(const char* path, int64_t topk) {
  std::ifstream f(path);
  if (!f.is_open()) return -1;
  auto store = std::make_unique<Store>();
  std::string line;
  std::vector<uint8_t> scratch;
  std::vector<std::pair<int, Record>> rows;
  std::map<int, int64_t> dim_seen;  // dim -> parsed rows
  while (std::getline(f, line)) {
    Record rec;
    const char* p = line.c_str();
    const int d = parse_row(p, p + line.size(), &rec, scratch);
    if (d < 0) continue;
    rows.emplace_back(d, std::move(rec));
    // topk early-exit with a slack window: only stop once we have
    // scanned enough extra rows that a short corrupt prefix cannot
    // win the majority vote (a corrupt block longer than the slack
    // can still win — bounded scans cannot rule that out; the full
    // scan without topk is immune).
    ++dim_seen[d];
    if (topk >= 0 && (int64_t)rows.size() >= topk + 64) {
      int64_t lead = 0;
      for (const auto& kv : dim_seen) lead = std::max(lead, kv.second);
      if (lead >= topk) break;
    }
  }
  finalize_rows(&rows, topk, store.get());
  g_stores.push_back(store.release());
  return (int64_t)g_stores.size() - 1;
}

// Multithreaded tsv_open: reads the file once, splits it into rows,
// base64-decodes rows on `n_threads` workers, then merges in file
// order with exactly tsv_open's validation/topk/feat-dim semantics.
// The base64 decode dominates open time, so the decode parallelises
// across cores. Equality with the sequential parser is tested
// (tests/test_torch_native.py); chip_smoke.py times both parses against
// the Python reader.
int64_t tsv_open_mt(const char* path, int64_t topk, int n_threads) {
  if (n_threads <= 1) return tsv_open(path, topk);
#ifdef __GLIBC__
  // Each record's feature vector (~300 KB at 36x2048) exceeds glibc's
  // default 128 KB mmap threshold, so parallel decoding serialises on
  // the kernel's mmap lock; keep those allocations in the per-thread
  // heap arenas instead.
  mallopt(M_MMAP_THRESHOLD, 16 * 1024 * 1024);
#endif
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f.is_open()) return -1;
  const int64_t size = f.tellg();
  f.seekg(0);
  // uninitialised buffer: std::string::resize would memset the whole
  // file size before the read overwrites it
  std::unique_ptr<char[]> data(new char[(size_t)size + 1]);
  if (size > 0 && !f.read(data.get(), size)) return -1;

  // row boundaries
  std::vector<std::pair<const char*, const char*>> rows;
  {
    const char* p = data.get();
    const char* end = p + size;
    while (p < end) {
      const char* nl = (const char*)memchr(p, '\n', end - p);
      const char* stop = nl ? nl : end;
      const char* trimmed = stop;
      while (trimmed > p && trimmed[-1] == '\r') --trimmed;
      if (trimmed > p) rows.emplace_back(p, trimmed);
      if (!nl) break;
      p = nl + 1;
    }
  }
  // topk counts VALID records, and validity is only known after the
  // decode — so decode every row and apply topk at the ordered merge.
  // (A small topk over a huge file wants the sequential tsv_open.)
  const size_t n_rows = rows.size();

  struct Slot {
    Record rec;
    int dim = -1;
  };
  std::vector<Slot> slots(n_rows);
  std::atomic<size_t> next{0};
  std::vector<std::thread> workers;
  const int T = n_threads;
  workers.reserve(T);
  for (int t = 0; t < T; ++t) {
    workers.emplace_back([&]() {
      std::vector<uint8_t> scratch;
      for (;;) {
        const size_t i = next.fetch_add(1);
        if (i >= n_rows) return;
        slots[i].dim =
            parse_row(rows[i].first, rows[i].second, &slots[i].rec, scratch);
      }
    });
  }
  for (auto& w : workers) w.join();

  auto store = std::make_unique<Store>();
  std::vector<std::pair<int, Record>> parsed;
  parsed.reserve(n_rows);
  for (size_t i = 0; i < n_rows; ++i)
    parsed.emplace_back(slots[i].dim, std::move(slots[i].rec));
  finalize_rows(&parsed, topk, store.get());
  g_stores.push_back(store.release());
  return (int64_t)g_stores.size() - 1;
}

namespace {
Store* store_at(int64_t h) {
  if (h < 0 || (size_t)h >= g_stores.size()) return nullptr;
  return g_stores[(size_t)h];
}
}  // namespace

int64_t tsv_count(int64_t h) {
  const Store* s = store_at(h);
  return s ? (int64_t)s->records.size() : -1;
}

int tsv_feat_dim(int64_t h) {
  const Store* s = store_at(h);
  return s ? s->feat_dim : -1;
}

// Copy record i. Caller provides buffers; boxes [max_boxes*4],
// features [max_boxes*feat_dim], ids/conf [max_boxes]. Returns the
// clipped number of boxes, or -1 for an invalid handle/index.
int tsv_get(int64_t h, int64_t i, char* img_id_out, int img_id_cap,
            int* img_h, int* img_w, float* boxes, float* features,
            int64_t* objects_id, float* objects_conf, int max_boxes) {
  const Store* s = store_at(h);
  if (!s || i < 0 || (size_t)i >= s->records.size()) return -1;
  const Record& r = s->records[(size_t)i];
  std::snprintf(img_id_out, img_id_cap, "%s", r.img_id.c_str());
  *img_h = r.img_h;
  *img_w = r.img_w;
  const int feat_dim = g_stores[h]->feat_dim;
  const int n = r.num_boxes < max_boxes ? r.num_boxes : max_boxes;
  std::memcpy(boxes, r.boxes.data(), (size_t)n * 4 * sizeof(float));
  std::memcpy(features, r.features.data(),
              (size_t)n * feat_dim * sizeof(float));
  const int nid = (int)r.objects_id.size() < n ? (int)r.objects_id.size() : n;
  std::memcpy(objects_id, r.objects_id.data(), (size_t)nid * sizeof(int64_t));
  const int nc = (int)r.objects_conf.size() < n ? (int)r.objects_conf.size() : n;
  std::memcpy(objects_conf, r.objects_conf.data(), (size_t)nc * sizeof(float));
  return n;
}

// Boxes of record i (its num_boxes), or -1 for an invalid handle/index.
int tsv_num_boxes(int64_t h, int64_t i) {
  const Store* s = store_at(h);
  if (!s || i < 0 || (size_t)i >= s->records.size()) return -1;
  return s->records[(size_t)i].num_boxes;
}

// Copy record i's attribute ids and confidences (buffers of max_boxes,
// zero-filled by the caller; a payload shorter than the record's boxes
// leaves the rest as it was). Returns the clipped number of boxes, or -1.
int tsv_get_attrs(int64_t h, int64_t i, int64_t* attrs_id,
                  float* attrs_conf, int max_boxes) {
  const Store* s = store_at(h);
  if (!s || i < 0 || (size_t)i >= s->records.size()) return -1;
  const Record& r = s->records[(size_t)i];
  const int n = r.num_boxes < max_boxes ? r.num_boxes : max_boxes;
  const int na = (int)r.attrs_id.size() < n ? (int)r.attrs_id.size() : n;
  std::memcpy(attrs_id, r.attrs_id.data(), (size_t)na * sizeof(int64_t));
  const int nc = (int)r.attrs_conf.size() < n ? (int)r.attrs_conf.size() : n;
  std::memcpy(attrs_conf, r.attrs_conf.data(), (size_t)nc * sizeof(float));
  return n;
}

void tsv_close(int64_t h) {
  if (h < 0 || (size_t)h >= g_stores.size()) return;
  delete g_stores[(size_t)h];
  g_stores[(size_t)h] = nullptr;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Prefetching batch loader: the torch-DataLoader-worker equivalent.
//
// Assembles model-ready padded batches (features [B, max_boxes, D],
// LXMERT-normalised boxes [B, max_boxes, 4], per-sample box counts)
// from an open store on background threads into a bounded in-order
// queue, so the Python side's next() is a single buffer copy that
// overlaps with device compute. Batches follow the caller-supplied
// sample order (the reference shuffles indices host-side the same
// way, lxmert/perturbation.py:205-210).
// ---------------------------------------------------------------------------

namespace {

struct BatchBuf {
  std::vector<float> feats;   // [B * max_boxes * D]
  std::vector<float> boxes;   // [B * max_boxes * 4]
  std::vector<int32_t> nbox;  // [B]
  int k = 0;                  // valid samples (tail batch may be short)
};

struct Loader {
  const Store* store = nullptr;
  std::vector<int64_t> order;
  int batch = 0, max_boxes = 0, depth = 2;
  bool normalize = true;
  int64_t n_batches = 0;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<int64_t, std::unique_ptr<BatchBuf>> ready;
  int64_t next_ticket = 0;  // next batch index to assemble
  int64_t next_out = 0;     // next batch index to hand out
  bool stop = false;

  void assemble(int64_t b, BatchBuf* out) const {
    const int D = store->feat_dim;
    out->feats.assign((size_t)batch * max_boxes * D, 0.f);
    out->boxes.assign((size_t)batch * max_boxes * 4, 0.f);
    out->nbox.assign(batch, 0);
    const int64_t start = b * batch;
    const int64_t stop_i =
        std::min<int64_t>(start + batch, (int64_t)order.size());
    out->k = (int)(stop_i - start);
    for (int64_t i = start; i < stop_i; ++i) {
      const Record& r = store->records[(size_t)order[(size_t)i]];
      const int n = r.num_boxes < max_boxes ? r.num_boxes : max_boxes;
      const int64_t s = i - start;
      std::memcpy(&out->feats[(size_t)s * max_boxes * D],
                  r.features.data(), (size_t)n * D * sizeof(float));
      float* bx = &out->boxes[(size_t)s * max_boxes * 4];
      const float iw = r.img_w > 0 ? 1.f / (float)r.img_w : 0.f;
      const float ih = r.img_h > 0 ? 1.f / (float)r.img_h : 0.f;
      for (int j = 0; j < n; ++j) {
        const float* src = &r.boxes[(size_t)j * 4];
        if (normalize) {
          bx[j * 4 + 0] = src[0] * iw;
          bx[j * 4 + 1] = src[1] * ih;
          bx[j * 4 + 2] = src[2] * iw;
          bx[j * 4 + 3] = src[3] * ih;
        } else {
          std::memcpy(&bx[j * 4], src, 4 * sizeof(float));
        }
      }
      out->nbox[(size_t)s] = n;
    }
  }

  void worker() {
    for (;;) {
      int64_t ticket;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop || (next_ticket < n_batches &&
                          next_ticket - next_out < depth);
        });
        if (stop || next_ticket >= n_batches) return;
        ticket = next_ticket++;
      }
      auto buf = std::make_unique<BatchBuf>();
      assemble(ticket, buf.get());
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace(ticket, std::move(buf));
      }
      cv_ready.notify_all();
    }
  }
};

std::vector<Loader*> g_loaders;

}  // namespace

extern "C" {

// Create a loader over an open store. `order`/`n` select and order the
// samples; depth bounds the number of assembled-but-unconsumed batches.
// Returns a handle or -1.
int64_t loader_create(int64_t tsv_handle, const int64_t* order, int64_t n,
                      int batch, int max_boxes, int depth, int n_threads,
                      int normalize) {
  const Store* s = store_at(tsv_handle);
  if (!s || batch <= 0 || max_boxes <= 0 || n < 0) return -1;
  for (int64_t i = 0; i < n; ++i)
    if (order[i] < 0 || (size_t)order[i] >= s->records.size()) return -1;
  auto L = std::make_unique<Loader>();
  L->store = s;
  L->order.assign(order, order + n);
  L->batch = batch;
  L->max_boxes = max_boxes;
  L->depth = depth > 0 ? depth : 2;
  L->normalize = normalize != 0;
  L->n_batches = (n + batch - 1) / batch;
  const int T = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < T && t < L->depth; ++t)
    L->workers.emplace_back(&Loader::worker, L.get());
  g_loaders.push_back(L.release());
  return (int64_t)g_loaders.size() - 1;
}

// Copy the next batch into caller buffers (feats [batch*max_boxes*D],
// boxes [batch*max_boxes*4], nbox [batch]). Returns the number of
// valid samples (0 < k <= batch), or 0 when exhausted, -1 on error.
int loader_next(int64_t h, float* feats, float* boxes, int32_t* nbox) {
  if (h < 0 || (size_t)h >= g_loaders.size() || !g_loaders[(size_t)h])
    return -1;
  Loader* L = g_loaders[(size_t)h];
  std::unique_ptr<BatchBuf> buf;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    if (L->next_out >= L->n_batches) return 0;
    L->cv_ready.wait(lk, [&] {
      return L->ready.count(L->next_out) > 0;
    });
    auto it = L->ready.find(L->next_out);
    buf = std::move(it->second);
    L->ready.erase(it);
    ++L->next_out;
  }
  L->cv_space.notify_all();
  std::memcpy(feats, buf->feats.data(), buf->feats.size() * sizeof(float));
  std::memcpy(boxes, buf->boxes.data(), buf->boxes.size() * sizeof(float));
  std::memcpy(nbox, buf->nbox.data(), buf->nbox.size() * sizeof(int32_t));
  return buf->k;
}

int64_t loader_num_batches(int64_t h) {
  if (h < 0 || (size_t)h >= g_loaders.size() || !g_loaders[(size_t)h])
    return -1;
  return g_loaders[(size_t)h]->n_batches;
}

void loader_destroy(int64_t h) {
  if (h < 0 || (size_t)h >= g_loaders.size() || !g_loaders[(size_t)h])
    return;
  Loader* L = g_loaders[(size_t)h];
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_space.notify_all();
  for (auto& w : L->workers) w.join();
  delete L;
  g_loaders[(size_t)h] = nullptr;
}

}  // extern "C"
