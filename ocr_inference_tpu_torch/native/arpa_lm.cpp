// Native ARPA n-gram language model scorer (KenLM-equivalent capability);
// the port's copy of ocr_inference_tpu/native/arpa_lm.cpp, unchanged in
// code, so both packages score with the same float32 tables.
//
// The reference rescored CTC beams with KenLM binary models through
// pyctcdecode (reference: BDRC/inference.py:95-106). This library loads the
// .arpa text model the BDRC repos also ship (reference download path:
// BDRC/utils.py:132-159) into a flat hash table and serves
// log10 P(token | context) with Katz backoff over interned token ids.
// Exposed via a C ABI consumed from Python through ctypes; the Python
// ArpaLM class in decode/arpa_lm.py is the behavioral reference — both
// implementations are cross-checked in the test suite.
//
// Built at first use by ocr_inference_tpu_torch/native/__init__.py
// (build_library("arpa_lm.cpp")) into ocr_inference_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Entry {
    float logp;
    float backoff;
};

// FNV-1a over a token-id sequence
struct IdSeqHash {
    size_t operator()(const std::vector<int32_t>& v) const {
        size_t h = 1469598103934665603ull;
        for (int32_t x : v) {
            h ^= (size_t)(uint32_t)x;
            h *= 1099511628211ull;
        }
        return h;
    }
};

struct Lm {
    int order = 0;
    std::unordered_map<std::string, int32_t> vocab;
    std::unordered_map<std::vector<int32_t>, Entry, IdSeqHash> table;
    int32_t unk_id = -1;

    int32_t intern(const std::string& tok) {
        auto it = vocab.find(tok);
        if (it != vocab.end()) return it->second;
        int32_t id = (int32_t)vocab.size();
        vocab.emplace(tok, id);
        return id;
    }

    int32_t lookup(const std::string& tok) const {
        auto it = vocab.find(tok);
        return it == vocab.end() ? -1 : it->second;
    }
};

}  // namespace

extern "C" {

void* ocr_arpa_load(const char* path) {
    std::ifstream f(path);
    if (!f.is_open()) return nullptr;
    Lm* lm = new Lm();
    std::string line;
    int section = 0;
    std::vector<int32_t> key;
    while (std::getline(f, line)) {
        // strip
        size_t b = line.find_first_not_of(" \t\r\n");
        if (b == std::string::npos) continue;
        size_t e = line.find_last_not_of(" \t\r\n");
        line = line.substr(b, e - b + 1);
        if (line.empty()) continue;
        if (line[0] == '\\') {
            size_t dash = line.find("-grams:");
            if (dash != std::string::npos) {
                section = std::stoi(line.substr(1, dash - 1));
                if (section > lm->order) lm->order = section;
            } else {
                section = 0;
            }
            continue;
        }
        if (section == 0) continue;
        std::istringstream ss(line);
        double logp;
        if (!(ss >> logp)) continue;
        key.clear();
        std::string tok;
        bool ok = true;
        for (int i = 0; i < section; ++i) {
            if (!(ss >> tok)) { ok = false; break; }
            key.push_back(lm->intern(tok));
        }
        if (!ok) continue;
        double backoff = 0.0;
        ss >> backoff;  // optional
        lm->table[key] = Entry{(float)logp, (float)backoff};
    }
    std::string unk = "<unk>";
    lm->unk_id = lm->lookup(unk);
    return lm;
}

void ocr_arpa_free(void* handle) { delete (Lm*)handle; }

int ocr_arpa_order(void* handle) { return ((Lm*)handle)->order; }

// Token id for a UTF-8 token, or -1 when unknown.
int32_t ocr_arpa_token_id(void* handle, const char* token) {
    return ((Lm*)handle)->lookup(token);
}

// log10 P(token | context); context is an id array (oldest first), ids may
// be -1 for OOV tokens. KenLM semantics: unknown words map to <unk>
// BEFORE scoring (kenlm lm/vocab id 0) so an unknown context word
// contributes <unk>'s backoff weight — keeps this scorer consistent with
// decode.arpa_lm.ArpaLM and the .binary readers.
double ocr_arpa_score(void* handle, const int32_t* context, int n_context,
                      int32_t token) {
    Lm* lm = (Lm*)handle;
    int max_ctx = lm->order > 1 ? lm->order - 1 : 0;
    int start = n_context > max_ctx ? n_context - max_ctx : 0;

    if (token < 0) token = lm->unk_id;
    std::vector<int32_t> ctx(context + start, context + n_context);
    for (int32_t& id : ctx)
        if (id < 0) id = lm->unk_id;
    double backoff_sum = 0.0;
    while (true) {
        if (token >= 0) {
            std::vector<int32_t> key = ctx;
            key.push_back(token);
            auto it = lm->table.find(key);
            if (it != lm->table.end()) return backoff_sum + it->second.logp;
        }
        if (ctx.empty()) {
            // <unk> itself unmodeled: a harsh finite penalty
            return backoff_sum - 10.0;
        }
        auto bo = lm->table.find(ctx);
        if (bo != lm->table.end()) backoff_sum += bo->second.backoff;
        ctx.erase(ctx.begin());
    }
}

}  // extern "C"
