// Native formula tokenizer + composition parser (C++17, ctypes ABI).
//
// The host-side hot path of the input pipeline: encoding ~50K formula
// strings into the 4752-token semantic vocabulary and parsing element
// compositions.  The reference does this in per-formula Python regex
// (reference: src/superconductor/tokenizer/fraction_tokenizer.py:380-476 and
// the parse loops in scripts/train_v12_clean.py:1988-2009); this
// implementation is a single hand-rolled scanner over the byte stream,
// ~50-100x faster, exposed through a C ABI for ctypes (no pybind11 in the
// image).
//
// Vocabulary layout (must match tokenizer/fraction_tokenizer.py):
//   0..4 PAD/BOS/EOS/UNK/FRAC_UNK, 5..122 elements, 123..142 ints 1..20,
//   143.. fractions, then ISO_UNK and isotopes.

#include <cstdint>
#include <cstring>
#include <numeric>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int PAD = 0, BOS = 1, EOS = 2, UNK = 3, FRAC_UNK = 4;
constexpr int N_SPECIAL = 5, N_ELEMENTS = 118, MAX_INT = 20;
constexpr int ELEM_START = N_SPECIAL;                 // 5
constexpr int INT_START = N_SPECIAL + N_ELEMENTS;     // 123
constexpr int FRAC_START = INT_START + MAX_INT;       // 143

const char* kElements[N_ELEMENTS] = {
    "H","He","Li","Be","B","C","N","O","F","Ne","Na","Mg","Al","Si","P","S",
    "Cl","Ar","K","Ca","Sc","Ti","V","Cr","Mn","Fe","Co","Ni","Cu","Zn","Ga",
    "Ge","As","Se","Br","Kr","Rb","Sr","Y","Zr","Nb","Mo","Tc","Ru","Rh","Pd",
    "Ag","Cd","In","Sn","Sb","Te","I","Xe","Cs","Ba","La","Ce","Pr","Nd","Pm",
    "Sm","Eu","Gd","Tb","Dy","Ho","Er","Tm","Yb","Lu","Hf","Ta","W","Re","Os",
    "Ir","Pt","Au","Hg","Tl","Pb","Bi","Po","At","Rn","Fr","Ra","Ac","Th","Pa",
    "U","Np","Pu","Am","Cm","Bk","Cf","Es","Fm","Md","No","Lr","Rf","Db","Sg",
    "Bh","Hs","Mt","Ds","Rg","Cn","Nh","Fl","Mc","Lv","Ts","Og"};

struct Vocab {
  std::unordered_map<std::string, int> elem_to_id;   // symbol -> token id
  std::unordered_map<std::string, int> elem_to_z;    // symbol -> Z
  std::unordered_map<std::string, int> frac_to_id;   // "p/q" -> token id
  std::unordered_map<std::string, int> iso_to_id;    // "18O" -> token id
  int iso_unk = -1;
  bool ready = false;
};

Vocab g_vocab;

inline long long gcd_ll(long long a, long long b) {
  while (b) { long long t = a % b; a = b; b = t; }
  return a < 0 ? -a : a;
}

// scan an element symbol at s[i]; returns symbol length (1/2) or 0
inline int scan_element(const char* s, size_t i, size_t n, std::string* out) {
  if (i >= n || s[i] < 'A' || s[i] > 'Z') return 0;
  if (i + 1 < n && s[i + 1] >= 'a' && s[i + 1] <= 'z') {
    std::string two(s + i, 2);
    if (g_vocab.elem_to_id.count(two)) { *out = two; return 2; }
  }
  std::string one(s + i, 1);
  if (g_vocab.elem_to_id.count(one)) { *out = one; return 1; }
  // unknown capital (possibly with lowercase tail) — report as 1-char unknown
  *out = one;
  return 1;
}

inline size_t scan_uint(const char* s, size_t i, size_t n, long long* val) {
  size_t j = i;
  long long v = 0;
  while (j < n && s[j] >= '0' && s[j] <= '9' && j - i < 18) {
    v = v * 10 + (s[j] - '0');
    ++j;
  }
  *val = v;
  return j - i;
}

}  // namespace

extern "C" {

// Initialize the vocabulary. fractions: n_frac C strings "p/q" in token
// order; isotopes: n_iso C strings "18O" in token order.
void sc_init(const char** fractions, int n_frac,
             const char** isotopes, int n_iso) {
  g_vocab = Vocab();
  for (int i = 0; i < N_ELEMENTS; ++i) {
    g_vocab.elem_to_id[kElements[i]] = ELEM_START + i;
    g_vocab.elem_to_z[kElements[i]] = i + 1;
  }
  for (int i = 0; i < n_frac; ++i)
    g_vocab.frac_to_id[fractions[i]] = FRAC_START + i;
  g_vocab.iso_unk = FRAC_START + n_frac;
  for (int i = 0; i < n_iso; ++i)
    g_vocab.iso_to_id[isotopes[i]] = g_vocab.iso_unk + 1 + i;
  g_vocab.ready = true;
}

// Encode n formulas into out[n * max_len] (BOS ... EOS PAD*), matching
// FractionAwareTokenizer.encode(add_bos_eos=True, pad=True).
int sc_tokenize_batch(const char** formulas, int n, int max_len,
                      int32_t* out) {
  if (!g_vocab.ready) return -1;
  for (int fi = 0; fi < n; ++fi) {
    const char* s = formulas[fi];
    size_t len = std::strlen(s);
    std::vector<int32_t> ids;
    ids.reserve(32);
    size_t i = 0;
    while (i < len) {
      char c = s[i];
      if (c == '{') {  // isotope {mass}El
        long long mass;
        size_t di = scan_uint(s, i + 1, len, &mass);
        if (di > 0 && i + 1 + di < len && s[i + 1 + di] == '}') {
          size_t j = i + 2 + di;
          std::string sym;
          int el = scan_element(s, j, len, &sym);
          if (el > 0 && g_vocab.elem_to_id.count(sym)) {
            std::string key = std::to_string(mass) + sym;
            auto it = g_vocab.iso_to_id.find(key);
            ids.push_back(it != g_vocab.iso_to_id.end() ? it->second
                                                        : g_vocab.iso_unk);
            i = j + el;
            continue;
          }
        }
        ++i;  // stray '{'
        continue;
      }
      if (c == '(') {  // fraction (p/q)
        long long p, q;
        size_t dp = scan_uint(s, i + 1, len, &p);
        size_t sl = i + 1 + dp;
        if (dp > 0 && sl < len && s[sl] == '/') {
          size_t dq = scan_uint(s, sl + 1, len, &q);
          size_t close = sl + 1 + dq;
          if (dq > 0 && close < len && s[close] == ')') {
            long long g = gcd_ll(p, q);
            if (g > 0) { p /= g; q /= g; }
            std::string key = std::to_string(p) + "/" + std::to_string(q);
            auto it = g_vocab.frac_to_id.find(key);
            ids.push_back(it != g_vocab.frac_to_id.end() ? it->second
                                                         : FRAC_UNK);
            i = close + 1;
            continue;
          }
        }
        ++i;  // stray '('
        continue;
      }
      if (c >= 'A' && c <= 'Z') {
        std::string sym;
        int el = scan_element(s, i, len, &sym);
        auto it = g_vocab.elem_to_id.find(sym);
        ids.push_back(it != g_vocab.elem_to_id.end() ? it->second : UNK);
        // consume any lowercase tail of an unknown symbol
        i += el;
        if (it == g_vocab.elem_to_id.end())
          while (i < len && s[i] >= 'a' && s[i] <= 'z') ++i;
        continue;
      }
      if (c >= '0' && c <= '9') {
        long long v;
        size_t d = scan_uint(s, i, len, &v);
        ids.push_back(v >= 1 && v <= MAX_INT
                          ? INT_START + static_cast<int>(v) - 1 : UNK);
        i += d;
        continue;
      }
      ++i;  // anything else: skip
    }

    // BOS ... EOS, pad/truncate to max_len
    int32_t* row = out + static_cast<size_t>(fi) * max_len;
    row[0] = BOS;
    int pos = 1;
    for (size_t t = 0; t < ids.size() && pos < max_len - 1; ++t)
      row[pos++] = ids[t];
    if (static_cast<int>(ids.size()) + 2 <= max_len) {
      row[pos++] = EOS;
      while (pos < max_len) row[pos++] = PAD;
    } else {
      row[max_len - 1] = EOS;
    }
  }
  return 0;
}

// Parse compositions: out_idx/out_frac/out_mask are [n, max_elements];
// fractions are normalized to sum 1 over parsed amounts.  Isotopes fold
// into the parent element; repeated elements accumulate.
int sc_parse_compositions(const char** formulas, int n, int max_elements,
                          int32_t* out_idx, float* out_frac,
                          uint8_t* out_mask) {
  if (!g_vocab.ready) return -1;
  for (int fi = 0; fi < n; ++fi) {
    const char* s = formulas[fi];
    size_t len = std::strlen(s);
    std::vector<std::pair<int, double>> comp;  // (Z, amount) insertion order
    auto add = [&comp](int z, double amt) {
      for (auto& kv : comp)
        if (kv.first == z) { kv.second += amt; return; }
      comp.emplace_back(z, amt);
    };

    size_t i = 0;
    while (i < len) {
      char c = s[i];
      if (c == '{') {  // skip isotope prefix, element handled next
        long long mass;
        size_t di = scan_uint(s, i + 1, len, &mass);
        if (di > 0 && i + 1 + di < len && s[i + 1 + di] == '}') {
          i = i + 2 + di;
          continue;
        }
        ++i;
        continue;
      }
      if (c >= 'A' && c <= 'Z') {
        std::string sym;
        int el = scan_element(s, i, len, &sym);
        i += el;
        auto zit = g_vocab.elem_to_z.find(sym);
        if (zit == g_vocab.elem_to_z.end()) {
          while (i < len && s[i] >= 'a' && s[i] <= 'z') ++i;
          continue;
        }
        double amt = 1.0;
        if (i < len && s[i] == '(') {
          long long p, q;
          size_t dp = scan_uint(s, i + 1, len, &p);
          size_t sl = i + 1 + dp;
          if (dp > 0 && sl < len && s[sl] == '/') {
            long long dq_v;
            size_t dq = scan_uint(s, sl + 1, len, &dq_v);
            size_t close = sl + 1 + dq;
            if (dq > 0 && close < len && s[close] == ')' && dq_v != 0) {
              amt = static_cast<double>(p) / static_cast<double>(dq_v);
              i = close + 1;
            }
          }
        } else if (i < len && ((s[i] >= '0' && s[i] <= '9')
                               || (s[i] == '.' && i + 1 < len
                                   && s[i + 1] >= '0' && s[i + 1] <= '9'))) {
          // integer OR raw-source decimal subscript (Ba0.2La1.8), mirroring
          // the Python parse_formula_composition decimal branch — the
          // tokenizer itself never sees decimals (ingestion canonicalizes
          // to (p/q)), but composition parsing of raw CSVs must agree
          long long v = 0;
          i += scan_uint(s, i, len, &v);
          double val = static_cast<double>(v);
          if (i < len && s[i] == '.' && i + 1 < len
              && s[i + 1] >= '0' && s[i + 1] <= '9') {
            ++i;
            double scale = 0.1;
            while (i < len && s[i] >= '0' && s[i] <= '9') {
              val += (s[i] - '0') * scale;
              scale *= 0.1;
              ++i;
            }
          }
          amt = val;
        }
        add(zit->second, amt);
        continue;
      }
      ++i;
    }

    double total = 0;
    for (auto& kv : comp) total += kv.second;
    if (total <= 0) total = 1.0;

    int32_t* idx = out_idx + static_cast<size_t>(fi) * max_elements;
    float* frac = out_frac + static_cast<size_t>(fi) * max_elements;
    uint8_t* mask = out_mask + static_cast<size_t>(fi) * max_elements;
    for (int j = 0; j < max_elements; ++j) {
      if (j < static_cast<int>(comp.size())) {
        idx[j] = comp[j].first;
        frac[j] = static_cast<float>(comp[j].second / total);
        mask[j] = 1;
      } else {
        idx[j] = 0; frac[j] = 0.0f; mask[j] = 0;
      }
    }
  }
  return 0;
}

}  // extern "C"
